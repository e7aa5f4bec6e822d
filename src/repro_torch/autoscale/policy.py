"""Pluggable scaling policies: windowed signals in, decisions out.  The
port's copy of ``repro/autoscale/policy.py``.

Policies are deliberately dumb-and-pure: each looks at one application's
:class:`~repro_torch.autoscale.metrics.MetricsWindow` and emits a
:class:`Decision`; the :class:`~repro_torch.autoscale.controller.\
AutoscaleController` owns *when* decisions are applied (hysteresis,
cooldowns) and the handle owns *how* (``scale_up``/``scale_down``/
``park``).  Three built-ins:

* :class:`TargetTracking` -- the paper's feedback loop: track a TTFT /
  denial-rate target, growing by the §9.3 solved increment
  (``handle.sizing.step``) and shrinking when utilization stays low.
* :class:`IdleParker` -- request parking after a sustained idle window;
  unparking is demand-driven (``submit_request`` on a parked handle), so
  no policy ever needs to predict wake-ups.
* :class:`QuotaRebalancer` -- pod-level: resizes co-tenant ``PoolView``
  quotas on one shared pool in proportion to windowed demand, so the
  *provisioned* KV footprint tracks load instead of peak.

An application that opts into replica/batch scaling (a
:class:`~repro_torch.runtime.options.ScalePolicy` on its ``ServeOptions``)
gets three more, all target-tracking on windowed signals:

* :class:`ReplicaScaler` -- replica count follows queue depth per
  replica (scale out) and decode occupancy (scale in; the removed
  replica's requests migrate token-identically).
* :class:`BatchScaler` -- the continuous-batch admission width follows
  decode occupancy, doubling/halving between ``batch_min`` and
  ``batch_max`` (the runners are built for ``batch_max`` lanes up
  front, so the width moves inside them).
* :class:`PredictiveUnparker` -- the one policy that acts on a *parked*
  app: unpark ``unpark_lead_s`` ahead of the EWMA-forecast next
  arrival, so a periodic tenant's first request of the burst lands on a
  live engine instead of paying the warm-restart latency.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.autoscale.metrics import MetricsWindow

#: fallback scale increment when no §9.3 history solution exists yet
#: (matches the runtime's 64 MiB sizing quantum)
DEFAULT_STEP_BYTES = 64 << 20


@dataclass(frozen=True)
class Decision:
    """One policy's verdict for one application this tick."""

    # none | scale_up | scale_down | park | unpark
    # | add_replica | remove_replica | grow_batch | shrink_batch
    action: str = "none"
    amount_bytes: int = 0       # for scale_up / scale_down
    reason: str = ""
    amount: int = 0             # for grow_batch / shrink_batch (new width)

    @property
    def is_action(self) -> bool:
        return self.action != "none"


NONE = Decision()


def sizing_step_bytes(handle) -> int:
    """The §9.3 solved incremental grant for this application -- the
    increment the paper says runtime growth should use -- else one
    allocation quantum."""
    sz = getattr(handle, "sizing", None)
    if sz is not None and sz.feasible and sz.step > 0:
        return int(sz.step)
    return DEFAULT_STEP_BYTES


class AppPolicy:
    """Per-application policy interface."""

    #: a parked app normally has nothing to decide (unparking is
    #: demand-driven); only policies that opt in here are consulted
    #: while the app is parked (see PredictiveUnparker)
    acts_on_parked = False

    def decide(self, window: MetricsWindow, handle) -> Decision:
        raise NotImplementedError


class TargetTracking(AppPolicy):
    """Track latency/denial targets; scale by the solved sizing step.

    Scale-up triggers on either windowed denial pressure (the pool said
    no) or windowed TTFT above target (requests waited).  Scale-down
    triggers only when the app is demonstrably over-provisioned: zero
    denial pressure, pool utilization under ``shrink_utilization``, and
    latency comfortably inside target.
    """

    def __init__(self, *, ttft_target_s: Optional[float] = None,
                 denial_target_per_s: float = 0.5,
                 shrink_utilization: float = 0.25,
                 max_demand_factor: float = 2.0):
        self.ttft_target_s = ttft_target_s
        self.denial_target_per_s = float(denial_target_per_s)
        self.shrink_utilization = float(shrink_utilization)
        self.max_demand_factor = float(max_demand_factor)

    def _up_headroom(self, handle) -> int:
        """Growth is target-tracking, not open-ended: never beyond
        ``max_demand_factor`` x the app's own demand estimate (an
        unbounded loop would grow bytes forever on a persistent denial
        signal the bytes cannot fix)."""
        cap = int(self.max_demand_factor
                  * handle.app.capped_demand(handle.app.estimate_demand()))
        return cap - handle.job.demand_bytes

    def decide(self, w: MetricsWindow, handle) -> Decision:
        step = sizing_step_bytes(handle)
        r = w.rates
        denials = r.get("denials_per_s", 0.0) or 0.0
        headroom = self._up_headroom(handle)
        if denials > self.denial_target_per_s and headroom > 0:
            return Decision("scale_up", min(step, headroom),
                            f"denials/s {denials:.2f} > "
                            f"{self.denial_target_per_s:.2f}")
        ttft = r.get("ttft_s")
        if (self.ttft_target_s is not None and ttft is not None
                and ttft > self.ttft_target_s and headroom > 0):
            return Decision("scale_up", min(step, headroom),
                            f"ttft {ttft * 1e3:.1f}ms > "
                            f"{self.ttft_target_s * 1e3:.1f}ms")
        util = r.get("pool_utilization")
        ttft_ok = (self.ttft_target_s is None or ttft is None
                   or ttft <= 0.5 * self.ttft_target_s)
        # propose shrink only while there is shrinkable headroom --
        # at the structural floor the decision would be a no-op that
        # shadows lower-priority policies (the idle parker) forever
        shrinkable = (handle.job.demand_bytes
                      - handle.app.structural_floor()) > 0
        # the denial signal is an EWMA: it decays geometrically and
        # never reaches exactly zero, so gate the shrink on a fraction
        # of the target rather than equality
        denials_quiet = denials <= 0.25 * self.denial_target_per_s
        if (denials_quiet and util is not None and shrinkable
                and util < self.shrink_utilization and ttft_ok):
            return Decision("scale_down", step,
                            f"utilization {util:.2f} < "
                            f"{self.shrink_utilization:.2f}")
        return NONE


class IdleParker(AppPolicy):
    """Park an app after ``idle_s`` with no traffic at all (empty queue,
    nothing running, no admissions/decodes observed)."""

    def __init__(self, idle_s: float = 60.0):
        self.idle_s = float(idle_s)

    def decide(self, w: MetricsWindow, handle) -> Decision:
        if getattr(handle, "parked", False):
            return NONE
        if (w.idle_s >= self.idle_s
                and w.rates.get("queue_len", 0) == 0
                and w.rates.get("num_running", 0) == 0):
            return Decision("park",
                            reason=f"idle {w.idle_s:.1f}s >= "
                                   f"{self.idle_s:.1f}s")
        return NONE


def _decode_occupancy(w: MetricsWindow, handle) -> Optional[float]:
    """Running requests / total decode slots (replicas x batch width),
    from the window's gauges.  None until the window has observed."""
    rset = getattr(handle, "replica_set", None)
    if rset is None:
        return None
    running = w.rates.get("num_running")
    if running is None:
        return None
    slots = len(rset.replicas) * max(rset.max_batch, 1)
    return float(running) / max(slots, 1)


class ReplicaScaler(AppPolicy):
    """Target-track windowed queue depth per replica (out) and decode
    occupancy (in), inside ``[max(min_replicas, 1), max_replicas]``.
    Scale-to-zero is NOT this policy's job: the IdleParker parks the
    whole app (min_replicas=0 merely permits it)."""

    def __init__(self, scale):
        self.scale = scale

    def decide(self, w: MetricsWindow, handle) -> Decision:
        rset = getattr(handle, "replica_set", None)
        if rset is None or getattr(handle, "parked", False):
            return NONE
        n = len(rset.replicas)
        qlen = w.rates.get("queue_len")
        if qlen is None:
            return NONE                  # no window observed yet
        per_replica = float(qlen) / max(n, 1)
        if (n < self.scale.max_replicas
                and per_replica > self.scale.target_queue_per_replica):
            return Decision(
                "add_replica",
                reason=f"queue/replica {per_replica:.1f} > "
                       f"{self.scale.target_queue_per_replica:.1f}")
        occ = _decode_occupancy(w, handle)
        if (n > max(self.scale.min_replicas, 1) and qlen == 0
                and occ is not None and occ < self.scale.shrink_occupancy):
            return Decision(
                "remove_replica",
                reason=f"occupancy {occ:.2f} < "
                       f"{self.scale.shrink_occupancy:.2f} across {n} "
                       "replicas")
        return NONE


class BatchScaler(AppPolicy):
    """Target-track decode occupancy with the continuous-batch width,
    doubling / halving inside ``[batch_min, batch_max]``.  The runners
    were built for ``batch_max`` lanes up front (see
    ``TorchExecutor.build_replica``), so growing the width only admits
    more."""

    def __init__(self, scale):
        self.scale = scale

    def decide(self, w: MetricsWindow, handle) -> Decision:
        rset = getattr(handle, "replica_set", None)
        if (rset is None or getattr(handle, "parked", False)
                or self.scale.batch_max is None):
            return NONE
        mb = rset.max_batch
        occ = _decode_occupancy(w, handle)
        if occ is None:
            return NONE
        qlen = w.rates.get("queue_len", 0)
        if (occ >= self.scale.grow_occupancy and qlen > 0
                and mb < self.scale.batch_max):
            return Decision(
                "grow_batch", reason=f"occupancy {occ:.2f} >= "
                f"{self.scale.grow_occupancy:.2f} with queue {qlen:.0f}",
                amount=min(mb * 2, self.scale.batch_max))
        if (occ <= self.scale.shrink_occupancy and mb > self.scale.batch_min
                and w.window.get("decode_steps", 0) > 0):
            return Decision(
                "shrink_batch", reason=f"occupancy {occ:.2f} <= "
                f"{self.scale.shrink_occupancy:.2f}",
                amount=max(mb // 2, self.scale.batch_min))
        return NONE


class PredictiveUnparker(AppPolicy):
    """Unpark ahead of the EWMA-forecast next arrival.

    The window tracks the smoothed gap between arrival-bearing
    observations (``arrival_gap_s``); when ``now + lead_s`` reaches the
    forecast next arrival -- and the forecast is not already stale by
    more than ``horizon`` gaps -- the parked app is warm-restarted so
    the burst's first request finds a live engine.  Purely an
    optimization: a wrong forecast costs one park/unpark cycle, never
    correctness (unparking stays demand-driven regardless)."""

    acts_on_parked = True

    def __init__(self, lead_s: float = 1.0, horizon: float = 1.5):
        self.lead_s = float(lead_s)
        self.horizon = float(horizon)

    def decide(self, w: MetricsWindow, handle) -> Decision:
        if not getattr(handle, "parked", False):
            return NONE
        gap = w.rates.get("arrival_gap_s")
        last = w.last_arrival_t
        if gap is None or gap <= 0 or last is None or w.now is None:
            return NONE
        due = last + gap
        if (w.now + self.lead_s >= due
                and w.now <= last + self.horizon * gap):
            return Decision(
                "unpark", reason=f"forecast arrival in "
                f"{max(due - w.now, 0.0):.2f}s (gap EWMA {gap:.2f}s)")
        return NONE


class QuotaRebalancer:
    """Demand-weighted fair-share quota resize across one pod's tenants.

    Per tick, each active (non-parked) view's demand is the EWMA of
    ``used pages + pages denied this window``.  Uncontended, every app
    gets demand x ``headroom`` (floored at ``min_pages``) -- so idle
    tenants' provisioned quota collapses toward the floor; contended
    (wants exceed the pool), the pool is split proportionally.  Shrinks
    below current usage drain via ``PoolView.resize_quota``'s preemption
    path, never stranding pages.
    """

    # 4 pages = 512 tokens: room for one typical request when an app has
    # no request history yet (shrinking a never-served app to less would
    # permanently reject its first arrival)
    def __init__(self, *, min_pages: int = 4, headroom: float = 1.5,
                 alpha: float = 0.5, floor_quantile: float = 0.9,
                 floor_requests: int = 2):
        self.min_pages = int(min_pages)
        self.headroom = float(headroom)
        self.alpha = float(alpha)
        self.floor_quantile = float(floor_quantile)
        self.floor_requests = int(floor_requests)
        self._demand: Dict[tuple, float] = {}   # (scope, app) -> EWMA pages

    def _floor_pages(self, shared, app: str) -> int:
        """An idle tenant's quota floor: enough pages for
        ``floor_requests`` x a ``floor_quantile`` request from this
        app's decayed history.  Shrinking below one request turns the
        next burst's arrivals into permanent admission rejections
        (``max_pages > quota``), which no later quota raise can undo;
        keeping a couple of requests' worth lets a burst's head admit
        immediately instead of waiting one reconcile round."""
        if shared.history is not None:
            h = shared.history.get(app, "request", "pages")
            if h is not None and h.count:
                return max(self.min_pages,
                           self.floor_requests
                           * math.ceil(h.quantile(self.floor_quantile)))
        return self.min_pages

    def rebalance(self, shared, windows: Dict[str, MetricsWindow], *,
                  scope: str = "") -> Dict[str, int]:
        """Resize quotas on ``shared`` for every app with a window.
        Returns the quotas applied (empty when fewer than two tenants --
        a lone tenant keeps whatever quota it was configured with).
        ``scope`` namespaces the demand EWMA: app names are unique only
        per pod, and one rebalancer instance serves every pod."""
        demands: Dict[str, float] = {}
        for app, view in shared.views.items():
            w = windows.get(app)
            if w is None or view.parked:
                continue
            denied = 0
            pool_delta = w.window.get("pool")
            if isinstance(pool_delta, dict):
                denied = pool_delta.get("denials", 0)
            d_now = float(view.used + denied)
            key = (scope, app)
            prev = self._demand.get(key, d_now)
            d = self.alpha * d_now + (1.0 - self.alpha) * prev
            self._demand[key] = d
            demands[app] = d
        if len(demands) < 2:
            return {}
        floors = {a: self._floor_pages(shared, a) for a in demands}
        want = {a: max(floors[a], math.ceil(d * self.headroom))
                for a, d in demands.items()}
        total_want = sum(want.values())
        n = shared.num_pages
        if total_want > n:               # contended: proportional split
            quotas = {a: max(floors[a], (n * wv) // total_want)
                      for a, wv in want.items()}
        else:                            # uncontended: demand + headroom
            quotas = {a: min(wv, n) for a, wv in want.items()}
        for app, q in quotas.items():
            shared.views[app].resize_quota(q)
        return quotas


def default_policies(*, ttft_target_s: Optional[float] = None,
                     denial_target_per_s: float = 0.5,
                     idle_park_s: float = 60.0,
                     scale=None) -> List[AppPolicy]:
    """The stock per-app policy chain.  The parker runs FIRST: the
    controller stops at the first active decision, and a large app can
    emit shrink decisions for many ticks (one sizing step each) -- an
    app that has crossed the idle threshold must park immediately, not
    after its bytes have been ground down to the floor.

    ``scale`` (a :class:`~repro_torch.runtime.options.ScalePolicy`) appends
    the replica/batch scalers and predictive unparker after the parker
    but before byte-level target tracking: replica and width moves are
    cheaper and more reversible than byte grants, so they get first
    refusal on a pressure signal."""
    pols: List[AppPolicy] = [IdleParker(idle_s=idle_park_s)]
    if scale is not None:
        if scale.predictive_unpark:
            pols.append(PredictiveUnparker(lead_s=scale.unpark_lead_s))
        if scale.scales_replicas:
            pols.append(ReplicaScaler(scale))
        if scale.scales_batch:
            pols.append(BatchScaler(scale))
    pols.append(TargetTracking(ttft_target_s=ttft_target_s,
                               denial_target_per_s=denial_target_per_s))
    return pols
