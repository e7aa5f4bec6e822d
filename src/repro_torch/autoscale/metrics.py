"""Metrics windows: cumulative serving counters -> decayed per-window
rates.  The port's copy of ``repro/autoscale/metrics.py``.

:func:`stats_delta` turns two cumulative stats snapshots
(``AppHandle.stats_view.cumulative()``) into the counters of the window
between them, gauges taken as-of-now.  It backs ``StatsView.windowed``
and ``AppHandle.serving_stats(since=...)``.

:class:`MetricsWindow` is what the autoscale controller keeps per
application: fed one raw stats snapshot per control-plane tick, it holds

* ``window`` -- the raw deltas of the just-closed window (counters
  subtracted, gauges passed through),
* ``rates`` -- EWMA-smoothed derived signals (``ttft_s``,
  ``decode_step_s``, ``denials_per_s``, ``tokens_per_s``,
  ``utilization``, ``queue_len``, ``num_running``), the paper's decayed
  history applied to the control loop, and
* idleness tracking (``idle_s``) for the parking policy.
"""

from __future__ import annotations

from typing import Dict, Optional

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
class MetricsWindow:
    """Per-application window state for the autoscale controller.

    ``observe(stats, now)`` closes one window: the first call only
    establishes the baseline; every later call computes deltas against
    the previous raw snapshot and folds the derived rates into an EWMA
    with weight ``alpha`` on the new window (the §4.2 decaying-histogram
    idea applied to control signals).
    """

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)
        self.window: Dict = {}          # raw deltas of the last window
        self.rates: Dict[str, float] = {}   # EWMA-smoothed signals
        self.now: Optional[float] = None
        self.last_active_t: Optional[float] = None
        #: last observation that carried new arrivals (router submissions
        #: or engine admissions) -- the predictive unparker's anchor
        self.last_arrival_t: Optional[float] = None
        self._raw: Optional[Dict] = None
        self._t: Optional[float] = None

    def _smooth(self, key: str, value: Optional[float]) -> None:
        if value is None:
            return                       # no sample this window: hold
        prev = self.rates.get(key)
        self.rates[key] = (value if prev is None
                           else self.alpha * value
                           + (1.0 - self.alpha) * prev)

    def observe(self, stats: Dict, now: float) -> Dict:
        """Fold one raw ``serving_stats()`` snapshot taken at ``now``.
        Returns the smoothed ``rates`` dict."""
        now = float(now)
        self.now = now
        if self._raw is None:            # baseline window
            self._raw, self._t = stats, now
            self.last_active_t = now
            return self.rates
        dt = max(now - self._t, 1e-9)
        d = stats_delta(stats, self._raw)
        self.window = d
        self._raw, self._t = stats, now

        pool = d.get("pool", {}) if isinstance(d.get("pool"), dict) else {}
        self._smooth("ttft_s", d["mean_ttft_s"]
                     if d.get("ttft_count", 0) > 0 else None)
        self._smooth("decode_step_s", d["mean_decode_step_s"]
                     if d.get("decode_steps", 0) > 0 else None)
        self._smooth("denials_per_s", pool.get("denials", 0) / dt)
        self._smooth("tokens_per_s", d.get("tokens_generated", 0) / dt)
        self._smooth("admitted_per_s", d.get("admitted", 0) / dt)
        # arrival forecasting: front-end submissions when the app serves
        # through a router (admissions lag the router queue), else engine
        # admissions.  The smoothed inter-arrival gap is the predictive
        # unparker's periodicity estimate.
        router = d.get("router") if isinstance(d.get("router"), dict) else None
        arrivals = (router.get("submitted", 0) if router is not None
                    else d.get("admitted", 0))
        if arrivals > 0:
            if self.last_arrival_t is not None:
                self._smooth("arrival_gap_s",
                             (now - self.last_arrival_t) / arrivals)
            self.last_arrival_t = now
        self._smooth("submitted_per_s", arrivals / dt)
        # gauges: tracked un-smoothed (the current truth matters)
        for g in ("queue_len", "num_running", "pool_utilization",
                  "pool_used_pages", "pool_quota_pages"):
            if g in d:
                self.rates[g] = d[g]
        if router is not None:
            self.rates["num_replicas"] = router.get("num_replicas", 1)
            self.rates["max_batch"] = router.get("max_batch", 0)
            self.rates["router_queue_len"] = router.get("queue_len", 0)

        active = (arrivals > 0
                  or d.get("admitted", 0) > 0 or d.get("prefills", 0) > 0
                  or d.get("decode_steps", 0) > 0
                  or d.get("queue_len", 0) > 0
                  or d.get("num_running", 0) > 0)
        if active or self.last_active_t is None:
            self.last_active_t = now
        return self.rates

    @property
    def idle_s(self) -> float:
        """Seconds of observed inactivity (0 until two observations)."""
        if self.now is None or self.last_active_t is None:
            return 0.0
        return max(self.now - self.last_active_t, 0.0)
