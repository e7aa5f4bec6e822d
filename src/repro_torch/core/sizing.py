"""History-based resource sizing (the paper's §9.3 optimization): a copy
of ``repro/core/sizing.py`` for the port's page pool.

For each component, pick an *initial size* and an *incremental size* so
that

    min_{step,init}  init + sum_h step * k_h * cost_factor
    s.t.             k_h * step + init >= h              for all h in History
                     sum_h max(init - h, 0) * t_h / sum_h h  <  Thres

where k_h = ceil((h - init) / step).  ``init`` and ``step`` are two
scalars over a discrete candidate set, solved exactly by vectorized
enumeration over the history support.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SizingSolution:
    init: float
    step: float
    expected_cost: float
    expected_scaleups: float
    waste_ratio: float
    feasible: bool


def solve_init_step(history: Sequence[Tuple[float, float]], *,
                    cost_factor: float = 0.3,
                    waste_threshold: float = 0.25,
                    exec_times: Optional[Sequence[float]] = None,
                    quantum: float = 1.0,
                    scale_penalty: Optional[float] = None) -> SizingSolution:
    """Exact solve of the §9.3 program over the weighted history.

    history: (value, weight) pairs.  quantum: allocation granularity.
    scale_penalty: latency cost charged per scale-up event (defaults to
    2x the quantum)."""
    if not history:
        return SizingSolution(quantum, quantum, 0.0, 0.0, 0.0, True)
    vals = np.asarray([max(quantum, v) for v, _ in history], np.float64)
    wts = np.asarray([w for _, w in history], np.float64)
    wts = wts / wts.sum()
    tms = (np.asarray(list(exec_times), np.float64)
           if exec_times is not None else np.ones_like(vals))
    peak = float(vals.max())

    qs = np.unique(np.concatenate([
        np.ceil(vals / quantum) * quantum,
        np.ceil(np.quantile(vals, [0.25, 0.5, 0.75, 0.9]) / quantum) * quantum,
        [quantum]]))
    inits = qs
    steps = np.unique(np.concatenate([
        qs, np.ceil((peak - qs) / (4 * quantum)) * quantum + quantum]))
    steps = steps[steps >= quantum]

    I = inits[:, None, None]
    S = steps[None, :, None]
    V = vals[None, None, :]
    W = wts[None, None, :]
    T = tms[None, None, :]

    if scale_penalty is None:
        scale_penalty = 2.0 * quantum
    k = np.ceil(np.maximum(V - I, 0.0) / S)
    cost = I[..., 0] * 1.0 + (k * S * cost_factor * W).sum(-1) \
        + (k * scale_penalty * W).sum(-1)
    waste = (np.maximum(I - V, 0.0) * T * W).sum(-1) / max(
        float((V * W).sum()), 1e-9)
    waste = np.broadcast_to(waste, cost.shape)
    feasible = waste < waste_threshold
    cost = np.where(feasible, cost, np.inf)

    i_idx, s_idx = np.unravel_index(np.argmin(cost), cost.shape)
    if not np.isfinite(cost[i_idx, s_idx]):
        return SizingSolution(peak, quantum, peak, 0.0, 0.0, False)
    init = float(inits[i_idx])
    step = float(steps[s_idx])
    ks = np.ceil(np.maximum(vals - init, 0.0) / step)
    return SizingSolution(
        init=init, step=step,
        expected_cost=float(cost[i_idx, s_idx]),
        expected_scaleups=float((ks * wts).sum()),
        waste_ratio=float(waste[i_idx, s_idx]),
        feasible=True)
