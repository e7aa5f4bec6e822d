"""Windowed serving stats: the port's copy of ``stats_delta`` and its
counter lists from ``repro/autoscale/metrics.py``.

:func:`stats_delta` turns two cumulative stats snapshots
(``AppHandle.stats_view.cumulative()``) into the counters of the window
between them, gauges taken as-of-now.  It backs
``StatsView.windowed``.  The reference's ``MetricsWindow`` (EWMA rates
for the autoscale controller) comes with the autoscale slice (queue
item A6).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs.metrics import hist_delta
from repro_torch.serving.engine import EngineStats

#: monotonic counters at the top level of a cumulative stats dict
ENGINE_COUNTERS = EngineStats.COUNTERS

#: monotonic counters inside its ``pool`` sub-dict (PagePool.stats)
POOL_COUNTERS = ("grants", "grant_pages", "denials", "scaleups", "released",
                 "prefix_unpinned", "prefix_evictions")

#: monotonic counters inside the ``router`` sub-dict
#: (RequestRouter.stats); the rest are gauges (queue_len, num_replicas,
#: max_batch)
ROUTER_COUNTERS = ("submitted", "dispatched", "replicas_added",
                   "replicas_removed")


def stats_delta(cur: Dict, since: Dict) -> Dict:
    """Windowed view of a cumulative stats dict: counters accumulated
    since the ``since`` snapshot, gauges (utilization, queue depth, pool
    sizes) taken from ``cur``.  Window means (``mean_ttft_s``,
    ``mean_decode_step_s``) are recomputed from the deltas.

    Counter resets clamp to zero: a fresh engine re-registered under an
    old app name restarts every counter at 0, and a window must report
    "no progress observed" rather than a huge negative rate.  The
    optional ``hist`` sub-dict (``obs`` latency histograms) windows
    per-bucket with the same reset semantics (see
    :func:`repro_torch.obs.metrics.hist_delta`)."""
    out = dict(cur)
    for k in ENGINE_COUNTERS:
        if k in out:
            out[k] = max(out[k] - since.get(k, 0), 0)
    out["mean_ttft_s"] = out.get("ttft_s_sum", 0.0) / max(
        out.get("ttft_count", 0), 1)
    out["mean_decode_step_s"] = out.get("decode_s_sum", 0.0) / max(
        out.get("decode_steps", 0), 1)
    if isinstance(cur.get("pool"), dict):
        spool = since.get("pool", {})
        if not isinstance(spool, dict):
            spool = {}
        out["pool"] = {k: max(v - spool.get(k, 0), 0)
                       if k in POOL_COUNTERS else v
                       for k, v in cur["pool"].items()}
    if isinstance(cur.get("shared_pool"), dict):
        sp = dict(cur["shared_pool"])
        ss = since.get("shared_pool", {})
        if not isinstance(ss, dict):
            ss = {}
        sp["cross_app_preemptions"] = max(
            sp.get("cross_app_preemptions", 0)
            - ss.get("cross_app_preemptions", 0), 0)
        for key in ("denials_by_app", "preemptions_by_app"):
            prev = ss.get(key, {})
            sp[key] = {a: max(n - prev.get(a, 0), 0)
                       for a, n in sp.get(key, {}).items()}
        out["shared_pool"] = sp
    if isinstance(cur.get("router"), dict):
        srt = since.get("router", {})
        if not isinstance(srt, dict):
            srt = {}
        out["router"] = {k: max(v - srt.get(k, 0), 0)
                         if k in ROUTER_COUNTERS else v
                         for k, v in cur["router"].items()}
    if isinstance(cur.get("replicas"), list):
        # per-replica breakdowns window by view name: replica indices
        # are reused across scale-down/up but each incarnation gets a
        # fresh pool view, so a missing/new view correctly deltas
        # against zero
        sreps = since.get("replicas")
        prev = ({e.get("view"): e for e in sreps if isinstance(e, dict)}
                if isinstance(sreps, list) else {})
        out["replicas"] = [
            {k: max(v - prev.get(e.get("view"), {}).get(k, 0), 0)
             if k in ENGINE_COUNTERS else v
             for k, v in e.items()}
            for e in cur["replicas"]]
    if isinstance(cur.get("hist"), dict):
        shist = since.get("hist", {})
        if not isinstance(shist, dict):
            shist = {}
        out["hist"] = {name: hist_delta(h, shist.get(name))
                       for name, h in cur["hist"].items()}
    return out
