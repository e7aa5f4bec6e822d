"""AdamW with fp32 master weights, global-norm clipping and schedules: a
copy of ``repro/training/optimizer.py``.

The state is a plain tree, so the checkpointer writes it in the
reference's format:

    opt_state = {"m": fp32, "v": fp32, "master": fp32, "count": int32}

``count`` is a 0-d int32 tensor kept on the host, so the schedule and
the bias corrections are computed there with no device sync.  Unlike the
reference, whose arrays are immutable, :func:`adamw_update` updates
``m``, ``v``, ``master`` and the gradients in place: at full
tinyllama-1.1b width a second copy of the fp32 state would be another
13 GB.  ``torch.optim.AdamW`` is not used: it applies the decay to the
weights before the Adam step, the reference adds it to the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step) -> float:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr`` at
    ``decay_steps``; computed in fp32 as the reference does."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(_f32(math.pi) * frac))
    return float(torch.where(step < cfg.warmup_steps, warm, cos))


def leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (the reference's
    pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Params, flat) -> Params:
    """The tree of ``like`` with the leaves of ``flat`` (in :func:`leaves`
    order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params: Params) -> Dict[str, Any]:
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "count": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


def adamw_update(grads: Params, opt_state: Dict[str, Any],
                 cfg: OptimizerConfig
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, Any]]:
    """Returns (new bf16 params, new opt state, metrics).  Updates the
    state's ``m``, ``v`` and ``master`` in place, and fp32 gradients too
    (see the module doc)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - _f32(b1) ** count.float())
    bc2 = float(1 - _f32(b2) ** count.float())
    for g, m, v, w in zip(leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"]),
                          leaves(opt_state["master"])):
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square_() * (1 - b2))
        step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        w.sub_(step.add_(w, alpha=cfg.weight_decay).mul_(lr))
    new_params = tree_map(lambda w: w.to(torch.bfloat16),
                          opt_state["master"])
    new_state = dict(opt_state, count=count)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
