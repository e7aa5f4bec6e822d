"""One stats surface for serving: :class:`StatsView`.  The port's copy
of ``repro/serving/stats.py``.

Every consumer of serving telemetry reads through one object with two
explicit temporal modes:

* ``cumulative()`` -- lifetime counters + current gauges, aggregated
  across the app's replicas (engine counters summed, including retired
  replicas so the totals stay monotonic across scale-down; queue depth
  = router queue + every engine queue; latency histograms merged
  across replica lanes).  The per-replica breakdown rides under a
  ``replicas`` key and the router's own counters under ``router``.
* ``windowed(since)`` -- counters as the delta accumulated since a
  ``cumulative()`` marker, gauges as-of-now.  Windowed results are
  tagged ``windowed=True`` and refused as markers (deltas of deltas are
  garbage).

The pod-shared pool (``shared_pool``), aliased-KV and prefix-cache keys
appear where the app's serving path has them, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import hist_merge
from repro_torch.serving.engine import EngineStats


def aggregate_engine_stats(handle) -> EngineStats:
    """Engine counters summed across an app's replicas -- including
    replicas already retired by scale-down, so totals stay monotonic.
    ``wall_s`` is a gauge: the max across live replicas rides along."""
    eng = handle.engine
    rset = handle.exec_state.get("replicas")
    reps = list(rset.replicas) if rset is not None else []
    engines = [r.engine for r in reps] or ([eng] if eng is not None else [])
    agg = EngineStats()
    for e in engines:
        for f in EngineStats.COUNTERS:
            setattr(agg, f, getattr(agg, f) + getattr(e.stats, f))
        agg.wall_s = max(agg.wall_s, e.stats.wall_s)
    if rset is not None:
        for f in EngineStats.COUNTERS:
            setattr(agg, f, getattr(agg, f) + getattr(rset.retired, f))
    return agg


class StatsView:
    """Cumulative | windowed serving stats for one application."""

    def __init__(self, handle):
        self.handle = handle

    # -- markers -------------------------------------------------------------
    def mark(self) -> Dict:
        """A raw snapshot usable as ``windowed(since=...)`` marker."""
        return self.cumulative()

    # -- temporal modes ------------------------------------------------------
    def cumulative(self) -> Dict:
        h = self.handle
        eng = h.engine
        if eng is None:
            return {}
        rset = h.exec_state.get("replicas")
        reps = list(rset.replicas) if rset is not None else []
        engines = [r.engine for r in reps] or [eng]
        # replicas removed by scale-down took their engines with them;
        # aggregate_engine_stats folds the set's retired tally back in
        out = aggregate_engine_stats(h).as_dict()
        out["queue_len"] = sum(len(e.queue) for e in engines)
        out["num_running"] = sum(len(e.running) for e in engines)
        if rset is not None and rset.router is not None:
            out["queue_len"] += rset.router.queue_len(h.app.name)
        out["parked"] = h.parked

        pools = [e.pool for e in engines]
        pool_counters: Dict[str, int] = {}
        for p in pools:
            for k, v in p.stats.items():
                pool_counters[k] = pool_counters.get(k, 0) + v
        out["pool"] = pool_counters
        used = sum(getattr(p, "used", p.num_pages - len(p.free))
                   for p in pools)
        quota = sum(p.num_pages for p in pools)
        if len(pools) == 1:
            out["pool_utilization"] = pools[0].utilization
        else:
            out["pool_utilization"] = used / max(quota, 1)
        out["pool_quota_pages"] = quota
        out["pool_used_pages"] = used
        if getattr(pools[0], "groups", None) is not None:
            # sliding-window stacks: ring (local-group) pages are charged
            # separately from the growing tables (see PageGroups)
            out["pool_used_local_pages"] = sum(p.used_local for p in pools)

        runners = [r.runner for r in reps if r.runner is not None] or (
            [h.runner] if h.runner is not None else [])
        runner = runners[0] if runners else None
        if runner is not None and getattr(runner, "store", None) is not None:
            # live device bytes of this app's KV tensors (gauge).  Replicas
            # AND aliased same-shape tenants report the SAME store: one
            # read, never a sum (the pod-level total is
            # shared_pool.kv_device_bytes below)
            out["kv_device_bytes"] = runner.store.device_bytes()
            out["kv_aliased"] = bool(getattr(runner, "shared_kv", False))
            out["kv_store_key"] = runner.store.key
        if runner is not None and hasattr(runner, "prefill_pages_computed"):
            # pages actually computed by prefill (cache hits subtract)
            out["prefill_pages_computed"] = sum(
                r.prefill_pages_computed for r in runners
                if hasattr(r, "prefill_pages_computed"))
        cache = getattr(runner, "prefix", None)
        if cache is not None:
            # global prefix cache: lifetime counters plus two gauges.
            # shared_pages counts cache-owned PHYSICAL pages: outside
            # every view's quota but inside the pod's used_pages
            out["prefix"] = dict(cache.stats)
            out["prefix_lookups"] = cache.stats["lookups"]
            out["prefix_hits"] = cache.stats["hits"]
            out["prefix_hit_rate"] = cache.hit_rate
            out["cow_copies"] = cache.stats["cow_copies"]
            out["shared_pages"] = cache.num_pages

        shared = getattr(pools[0], "shared", None)
        if shared is not None:
            out["shared_pool"] = {
                "num_pages": shared.num_pages,
                "used_pages": shared.used_pages,
                "utilization": shared.utilization,
                "denials_by_app": dict(shared.stats["denials"]),
                "preemptions_by_app": dict(shared.stats["preemptions"]),
                "cross_app_preemptions":
                    shared.stats["cross_app_preemptions"],
                "kv_device_bytes": shared.kv_device_bytes(),
            }

        m = obs_metrics.METRICS
        if m is not None:
            # latency histograms: each replica engine observes into its
            # own lane (app / app@rN); merge same-name histograms so the
            # windowed deltas see ONE monotonic series per metric
            by_name: Dict[str, List[Dict]] = {}
            for e in engines:
                lane = getattr(e, "_obs_app", None) or h.app.name
                for name, hd in m.app_histograms(lane).items():
                    by_name.setdefault(name, []).append(hd)
            if by_name:
                out["hist"] = {name: (ds[0] if len(ds) == 1
                                      else hist_merge(ds))
                               for name, ds in by_name.items()}

        if rset is not None:
            if rset.router is not None:
                out["router"] = rset.router.stats(h.app.name)
            out["replicas"] = [
                {"replica": r.idx,
                 "view": getattr(r.engine.pool, "app", h.app.name),
                 "queue_len": len(r.engine.queue),
                 "num_running": len(r.engine.running),
                 "max_batch": r.engine.max_batch,
                 **{f: getattr(r.engine.stats, f)
                    for f in EngineStats.COUNTERS}}
                for r in reps]
        out["windowed"] = False
        return out

    def windowed(self, since: Dict) -> Dict:
        """Counters since the ``since`` marker; gauges as-of-now."""
        if since.get("windowed"):
            raise ValueError(
                "windowed(since=...) needs a RAW snapshot (from "
                "cumulative()/mark()), not a windowed result: deltas of "
                "deltas are garbage")
        from repro_torch.autoscale.metrics import stats_delta
        out = stats_delta(self.cumulative(), since)
        out["windowed"] = True
        return out
