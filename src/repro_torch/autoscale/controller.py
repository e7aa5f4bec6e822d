"""The reconcile loop: ``Cluster.tick()`` drives one controller pass.
The port's copy of ``repro/autoscale/controller.py``.

Closes the paper's central feedback loop -- the platform, not the
application, decides when resources grow, shrink, and get reclaimed:

    serving_stats() --> MetricsWindow --> policies --> Decision
                                                        |
         scale_up / scale_down / park  <-- hysteresis --+
         (AppHandle)                       + cooldowns

Design points:

* **windowed input** -- each attached app gets a
  :class:`~repro_torch.autoscale.metrics.MetricsWindow`; the controller feeds
  it the raw cumulative ``serving_stats()`` each tick, so policies only
  ever see per-window rates.
* **hysteresis** -- a decision must repeat for ``confirm_ticks``
  consecutive ticks before it is applied (one noisy window never scales
  anything), and opposing streaks reset each other.
* **cooldowns** -- separate ``cooldown_up_s`` / ``cooldown_down_s``
  (shrinking is the dangerous direction: the paper's "avoid frequent
  small adjustments", §5.2.3).
* **scale-down floor** -- never below ``Application.structural_floor()``
  (params must stay resident; only the input-dependent share shrinks).
* **pod pass** -- after per-app decisions, the
  :class:`~repro_torch.autoscale.policy.QuotaRebalancer` resizes co-tenant
  quotas on every pod's shared pool.

Time is injectable (``tick(now=...)``) so tests and the event-driven
benchmark drive the loop on a logical clock.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.autoscale.metrics import MetricsWindow
from repro_torch.autoscale.policy import (AppPolicy, Decision, QuotaRebalancer,
                                    default_policies)
from repro_torch.obs import trace as obs_trace


@dataclass
class AppRecord:
    """Controller-side state for one attached application."""

    handle: object
    window: MetricsWindow
    policies: List[AppPolicy]
    streak: Dict[str, int] = field(default_factory=dict)
    last_up_t: float = float("-inf")
    last_down_t: float = float("-inf")


class AutoscaleController:
    """Owns metrics windows, policy evaluation, and actuation pacing."""

    def __init__(self, cluster, *,
                 make_policies=None,
                 rebalancer: Optional[QuotaRebalancer] = None,
                 rebalance_quotas: bool = True,
                 interval_s: float = 0.0,
                 cooldown_up_s: float = 0.0,
                 cooldown_down_s: float = 0.0,
                 confirm_ticks: int = 1,
                 window_alpha: float = 0.5):
        self.cluster = cluster
        self._make_policies = make_policies or default_policies
        self.rebalancer = rebalancer or QuotaRebalancer()
        self.rebalance_quotas = rebalance_quotas
        self.interval_s = float(interval_s)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.confirm_ticks = max(int(confirm_ticks), 1)
        self.window_alpha = float(window_alpha)
        self.apps: Dict[str, AppRecord] = {}
        self.log: List[Dict] = []
        self._last_tick: Optional[float] = None

    # -- membership ----------------------------------------------------------
    def attach(self, handle, policies: Optional[List[AppPolicy]] = None
               ) -> Optional[AppRecord]:
        """Manage one serve application (train apps are not autoscaled
        here: their growth path is compile-feedback escalation)."""
        if handle.app.kind != "serve":
            return None
        if policies is None:
            policies = self._call_make_policies(handle)
        rec = AppRecord(handle, MetricsWindow(alpha=self.window_alpha),
                        policies)
        self.apps[handle.job.job_id] = rec
        return rec

    def _call_make_policies(self, handle) -> List[AppPolicy]:
        """``make_policies`` may be per-app (takes the handle -- the
        default chain reads the app's ScalePolicy) or global (zero-arg,
        the pre-replica contract many callers still use)."""
        mk = self._make_policies
        try:
            sig = inspect.signature(mk)
            takes_handle = any(
                p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                for p in sig.parameters.values())
        except (TypeError, ValueError):   # builtins, odd callables
            takes_handle = False
        return mk(handle) if takes_handle else mk()

    def detach(self, handle) -> None:
        self.apps.pop(handle.job.job_id, None)

    # -- the reconcile pass --------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One control-plane round; returns the actions taken."""
        now = time.monotonic() if now is None else float(now)
        if (self._last_tick is not None and self.interval_s > 0
                and now - self._last_tick < self.interval_s):
            return []
        self._last_tick = now
        actions: List[Dict] = []
        for rec in list(self.apps.values()):
            h = rec.handle
            if h.state != "running":
                continue
            stats = h.serving_stats()
            if not stats:
                continue                 # engine not bound yet
            rec.window.observe(stats, now)
            # a parked app has almost nothing to decide: unparking is
            # demand-driven (submit_request), and letting scale policies
            # act on decaying pre-park signals would consume the park
            # reservation behind its back.  Only policies that opt in
            # via ``acts_on_parked`` (the predictive unparker) are
            # consulted -- _decide_and_apply filters the rest out.
            act = self._decide_and_apply(rec, now)
            if act is not None:
                actions.append(act)
        if self.rebalance_quotas:
            actions.extend(self._rebalance_pods())
        self.log.extend(actions)
        return actions

    def _decide_and_apply(self, rec: AppRecord, now: float
                          ) -> Optional[Dict]:
        decision = Decision()
        parked = getattr(rec.handle, "parked", False)
        for pol in rec.policies:
            if parked and not getattr(pol, "acts_on_parked", False):
                continue
            decision = pol.decide(rec.window, rec.handle)
            if decision.is_action:
                break
        if not decision.is_action:
            rec.streak.clear()
            return None
        # hysteresis: the SAME action for confirm_ticks consecutive ticks
        streak = rec.streak.get(decision.action, 0) + 1
        rec.streak = {decision.action: streak}
        if streak < self.confirm_ticks:
            return None
        act = self._apply(rec, decision, now)
        if act is not None:
            t = obs_trace.TRACER
            if t is not None:
                # the decision WITH its explanation: the rule that fired
                # and the windowed rates it saw this tick
                args = {"action": decision.action,
                        "reason": decision.reason}
                for k, v in rec.window.rates.items():
                    args["rate_" + k] = v
                t.instant("autoscale", "decision", rec.handle.app.name,
                          args)
        return act

    def _apply(self, rec: AppRecord, d: Decision, now: float
               ) -> Optional[Dict]:
        h = rec.handle
        entry = {"app": h.app.name, "action": d.action, "reason": d.reason,
                 "t": now}
        if d.action == "park":
            if h.parked:
                return None
            entry.update(h.park())
            rec.streak.clear()
            return entry
        if d.action == "unpark":
            if not h.parked:
                return None
            entry.update(h.unpark())
            rec.streak.clear()
            rec.last_up_t = now          # an unpark IS a scale-up event
            return entry
        if d.action == "add_replica":
            if now - rec.last_up_t < self.cooldown_up_s:
                return None
            h.add_replica()
            rec.last_up_t = now
            entry.update(num_replicas=h.num_replicas)
            return entry
        if d.action == "remove_replica":
            if now - rec.last_down_t < self.cooldown_down_s:
                return None
            receipt = h.remove_replica()
            rec.last_down_t = now
            entry.update(num_replicas=h.num_replicas, **receipt)
            return entry
        if d.action in ("grow_batch", "shrink_batch"):
            grow = d.action == "grow_batch"
            last = rec.last_up_t if grow else rec.last_down_t
            cool = self.cooldown_up_s if grow else self.cooldown_down_s
            if now - last < cool:
                return None
            applied = h.set_max_batch(d.amount)
            if grow:
                rec.last_up_t = now
            else:
                rec.last_down_t = now
            entry.update(max_batch=applied)
            return entry
        if d.action == "scale_up":
            if now - rec.last_up_t < self.cooldown_up_s:
                return None
            ok = h.scale_up(d.amount_bytes)
            if ok:
                rec.last_up_t = now
            entry.update(amount_bytes=d.amount_bytes, ok=ok)
            return entry
        if d.action == "scale_down":
            if now - rec.last_down_t < self.cooldown_down_s:
                return None
            floor = h.app.structural_floor()
            amount = min(d.amount_bytes,
                         max(h.job.demand_bytes - floor, 0))
            if amount <= 0:
                return None
            freed = h.scale_down(amount)
            rec.last_down_t = now
            entry.update(amount_bytes=amount, freed_bytes=freed)
            return entry
        return None

    def _rebalance_pods(self) -> List[Dict]:
        out = []
        for pod, pool in self.cluster._pod_pools.items():
            windows = {rec.handle.app.name: rec.window
                       for rec in self.apps.values()
                       if rec.handle.pod == pod}
            quotas = self.rebalancer.rebalance(pool, windows, scope=pod)
            if quotas:
                out.append({"action": "rebalance_quotas", "pod": pod,
                            "quotas": quotas})
                t = obs_trace.TRACER
                if t is not None:
                    t.instant("autoscale", "rebalance", pod,
                              {"quotas": dict(quotas)})
        return out

    # -- introspection -------------------------------------------------------
    def window_for(self, handle) -> Optional[MetricsWindow]:
        rec = self.apps.get(handle.job.job_id)
        return rec.window if rec else None
