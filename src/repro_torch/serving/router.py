"""Front-end request router + replica sets: the scale-out data plane.
The port's copy of ``repro/serving/router.py``.

* :class:`RequestRouter` -- one per pod (``Cluster.router``).  It owns
  one FIFO queue per application and continuously dispatches queued
  requests across the app's replicas, join-shortest-queue among the
  replicas with batch headroom.  Binding is late: a request waits in
  the router queue until some replica can actually grow its continuous
  batch.  Every app has its own queue and its own replicas, and
  ``step()`` services every app each round.

* :class:`ReplicaSet` -- N :class:`ServingEngine` replicas of ONE app.
  Each replica is its own ``PoolView`` (named ``app@rN`` past the first,
  all feeding the app's one sizing-history series), but all replicas
  share the pod's ``SharedPagePool``, ``KVArrayStore`` page tensors and
  prefix cache, and past the first replica the model params are aliased:
  a replica costs compute slots, not a second copy of KV or weights.

Removing a replica drains the victim engine (pages reclaimed, contents
intact on the card), the runner gathers the drained KV
(``migrate_out``), the requests re-pin their prefix and re-acquire pages
on a survivor's view, and the KV is written back at the new grants
(``migrate_in``): a token-identical continuation, because every replica
decodes through the same page tensors.  Requests that do not fit the
survivor (batch slots, pages, or a dense cache, which cannot migrate)
fall back to the at-least-once path: requeued at the router,
re-executed from scratch, still deterministic.  The migration resolves
the runtime sanitizer's park receipts as the reference's does
(``repro_torch.analysis.zensan``).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.analysis import zensan
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import EngineStats, ServingEngine
from repro_torch.serving.kv_cache import Request


def replica_view_name(app: str, idx: int) -> str:
    """Replica 0 keeps the bare app name (the handle's primary engine,
    stable across scaling); later replicas get suffixed view names."""
    return app if idx == 0 else f"{app}@r{idx}"


@dataclass
class Replica:
    """One engine lane of a ReplicaSet."""

    idx: int
    engine: ServingEngine
    runner: Optional[object] = None

    @property
    def load(self) -> int:
        return len(self.engine.running) + len(self.engine.queue)

    @property
    def headroom(self) -> int:
        return self.engine.max_batch - self.load


class ReplicaSet:
    """The data plane of one app: N engine replicas behind the router.

    ``build`` is an executor-provided factory ``(idx) -> Replica``; the
    set owns replica lifecycle (add / drain-and-remove / batch width)
    while the :class:`~repro_torch.autoscale.controller.AutoscaleController`
    stays pure control plane.
    """

    def __init__(self, app: str, build: Callable[[int], Replica], *,
                 initial: int = 1, app_weight: float = 1.0,
                 quota_pages: Optional[int] = None):
        self.app = app
        self._build = build
        self._next_idx = 0
        self.replicas: List[Replica] = []
        self.app_weight = app_weight
        self.quota_pages = quota_pages if isinstance(quota_pages, int) else None
        self.router: Optional["RequestRouter"] = None
        #: counters of replicas removed since birth (aggregated stats must
        #: stay monotonic when a replica's engine is discarded)
        self.retired = EngineStats()
        self.replicas_added = 0
        self.replicas_removed = 0
        try:
            for _ in range(max(initial, 1)):
                self.add_replica()
        except Exception:
            self.shutdown()
            raise

    @property
    def primary(self) -> Replica:
        """The replica behind ``AppHandle.engine`` (idx 0 never drains:
        remove picks the highest index)."""
        return self.replicas[0]

    # -- scaling dimensions --------------------------------------------------
    def add_replica(self) -> Replica:
        rep = self._build(self._next_idx)
        self._next_idx += 1
        self.replicas.append(rep)
        self.replicas_added += 1
        self._rebalance()
        t = obs_trace.TRACER
        if t is not None:
            t.instant("autoscale", "replica_add", self.app,
                      {"replica": rep.idx, "num_replicas": len(self.replicas)})
        return rep

    def remove_replica(self) -> Dict:
        """Drain the highest-index replica and migrate its in-flight
        requests to the least-loaded survivor; returns the migration
        receipt."""
        if len(self.replicas) <= 1:
            raise RuntimeError(f"{self.app}: cannot remove the last replica "
                               "(scale-to-zero is park)")
        victim = max(self.replicas, key=lambda r: r.idx)
        self.replicas.remove(victim)
        receipt = self._migrate(victim)
        for f in EngineStats.COUNTERS:
            setattr(self.retired, f, getattr(self.retired, f)
                    + getattr(victim.engine.stats, f))
        victim.engine.shutdown()        # frees nothing (drained); closes view
        self.replicas_removed += 1
        self._rebalance()
        t = obs_trace.TRACER
        if t is not None:
            t.instant("autoscale", "replica_remove", self.app,
                      {"replica": victim.idx,
                       "num_replicas": len(self.replicas), **receipt})
        return receipt

    def scale_to(self, n: int) -> Dict:
        n = max(int(n), 1)
        receipt: Dict = {"migrated_requests": 0, "requeued_requests": 0}
        while len(self.replicas) < n:
            self.add_replica()
        while len(self.replicas) > n:
            r = self.remove_replica()
            receipt["migrated_requests"] += r.get("migrated_requests", 0)
            receipt["requeued_requests"] += r.get("requeued_requests", 0)
        receipt["num_replicas"] = len(self.replicas)
        return receipt

    def set_max_batch(self, n: int) -> int:
        """Set the continuous-batch admission width on every replica,
        clamped to each runner's build-time compile-shape cap (both
        backends pad decode to the runner's ``max_batch``; growing past
        it would retrace or index out of the dense slot range).  Returns
        the width actually applied."""
        n = max(int(n), 1)
        applied = []
        for r in self.replicas:
            cap = getattr(r.runner, "max_batch", None)
            nb = min(n, cap) if cap else n
            r.engine.max_batch = nb
            applied.append(nb)
        return min(applied) if applied else n

    @property
    def max_batch(self) -> int:
        return min((r.engine.max_batch for r in self.replicas), default=0)

    def _rebalance(self) -> None:
        """Replica views split the app's tenancy evenly: the app's weight
        (and integer quota, when one was set) is divided across its
        replicas so scaling out never grows the app's fair share at
        co-tenants' expense."""
        n = len(self.replicas)
        if n == 0:
            return
        for r in self.replicas:
            view = r.engine.pool
            if hasattr(view, "weight"):
                view.weight = self.app_weight / n
            if self.quota_pages is not None and hasattr(view, "resize_quota"):
                view.resize_quota(max(self.quota_pages // n, 1))

    # -- replica-to-replica migration ----------------------------------------
    def _migrate(self, victim: Replica) -> Dict:
        """Hand the victim's work to survivors: queued requests go back to
        the router front; running ones drain (pages reclaimed, KV intact)
        and either re-grant + write back on the least-loaded survivor
        (token-identical) or requeue from scratch.  A runner moves its
        drained KV only when it says it can (``can_migrate``: the paged
        runner, whose replicas share one set of page tensors)."""
        target = min(self.replicas, key=lambda r: r.load)
        veng, teng = victim.engine, target.engine
        queued = list(veng.queue)
        veng.queue.clear()
        drained = veng.drain()
        migratable = (victim.runner is None
                      or getattr(victim.runner, "can_migrate", False))
        state = (victim.runner.migrate_out(drained)
                 if victim.runner is not None and migratable else None)
        reattach = getattr(target.runner, "prefix_reattach", None)
        restored: List[Request] = []
        requeued: List[Request] = []
        for req, (g_ids, l_ids) in drained:
            ok = False
            if (migratable
                    and len(teng.running) + len(restored) < teng.max_batch):
                # prefix re-pin first (the drained KV is the private pages
                # only), then the exact-count re-grant on the TARGET view,
                # reclaiming under pressure
                if reattach is None or reattach(req):
                    ok = teng.pool.regrant(req, len(g_ids), len(l_ids))
                    while not ok:
                        if not teng._reclaim():
                            break
                        ok = teng.pool.regrant(req, len(g_ids), len(l_ids))
                    if not ok:
                        teng.pool.prefix_detach(req)
                else:
                    teng.pool.prefix_detach(req)
            (restored if ok else requeued).append(req)
        if victim.runner is not None and restored:
            target.runner.migrate_in(state, restored)
        teng.running.extend(restored)
        s = zensan.SAN
        for req in requeued:            # at-least-once fallback
            req.generated = 0
            req.state = "queued"
        if s is not None:
            # every drained request holds a park receipt on the VICTIM
            # view (its regrant above landed on the target's ledger key):
            # resolve them all, then assert none went stranded before the
            # view closes
            for req, _ in drained:
                s.park_cancel(veng.pool, req.req_id)
            s.unpark_done(veng.pool, getattr(veng.pool, "app", self.app))
            s.check(veng.pool)
        if self.router is not None:
            self.router.requeue(self.app, requeued + queued)
        else:
            for req in reversed(requeued + queued):
                teng.queue.appendleft(req)
        t = obs_trace.TRACER
        if t is not None:
            for req in restored:
                t.instant("request", "migrate", req.req_id,
                          {"app": self.app, "from": victim.idx,
                           "to": target.idx, "restored": True})
            for req in requeued:
                t.instant("request", "migrate", req.req_id,
                          {"app": self.app, "from": victim.idx,
                           "to": target.idx, "restored": False})
        return {"migrated_requests": len(restored),
                "requeued_requests": len(requeued) + len(queued)}

    def shutdown(self) -> None:
        # primary last: if it is the store's final active user, its view
        # close drops the shared page tensors exactly once
        for r in sorted(self.replicas, key=lambda r: -r.idx):
            r.engine.shutdown()
        self.replicas.clear()


@dataclass
class _AppEntry:
    rset: ReplicaSet
    queue: Deque[Request] = field(default_factory=collections.deque)
    submitted: int = 0
    dispatched: int = 0


class RequestRouter:
    """Pod-level front door: one queue per app, continuous dispatch."""

    def __init__(self, pod: str = "pod"):
        self.pod = pod
        self.apps: Dict[str, _AppEntry] = {}

    def register(self, app: str, rset: ReplicaSet) -> None:
        if app in self.apps:
            raise ValueError(f"router({self.pod}): app {app!r} already "
                             "registered")
        self.apps[app] = _AppEntry(rset=rset)
        rset.router = self

    def unregister(self, app: str) -> None:
        entry = self.apps.pop(app, None)
        if entry is not None:
            entry.rset.router = None

    # -- ingress -------------------------------------------------------------
    def submit(self, app: str, req: Request) -> None:
        entry = self.apps[app]
        # arrival is stamped HERE, once: dispatch passes it through so
        # TTFT includes router-queue wait, not just engine-queue wait
        req.submitted_at = time.perf_counter()
        entry.queue.append(req)
        entry.submitted += 1
        self._dispatch(entry)

    def requeue(self, app: str, reqs: List[Request]) -> None:
        """Migration fallback: requests re-enter at the FRONT in order
        (they were admitted before anything currently waiting)."""
        entry = self.apps[app]
        entry.queue.extendleft(reversed(reqs))

    def queue_len(self, app: str) -> int:
        entry = self.apps.get(app)
        return len(entry.queue) if entry is not None else 0

    # -- dispatch + stepping -------------------------------------------------
    def _dispatch(self, entry: _AppEntry) -> int:
        """Join-shortest-queue among replicas with batch headroom; a
        request binds to a lane only when that lane can actually take
        it, otherwise it waits here (late binding)."""
        moved = 0
        t = obs_trace.TRACER
        while entry.queue:
            ready = [r for r in entry.rset.replicas if r.headroom > 0]
            if not ready:
                break
            target = min(ready, key=lambda r: (r.load, r.idx))
            req = entry.queue.popleft()
            target.engine.submit(req, submitted_at=req.submitted_at)
            entry.dispatched += 1
            moved += 1
            if t is not None:
                t.instant("request", "route", req.req_id,
                          {"app": entry.rset.app, "replica": target.idx,
                           "queue": len(entry.queue)})
        return moved

    def step_app(self, app: str) -> bool:
        """Dispatch + step every replica of one app.  Returns True while
        the app still has work anywhere (router queue included)."""
        entry = self.apps[app]
        self._dispatch(entry)
        alive = False
        for r in list(entry.rset.replicas):
            alive = r.engine.step() or alive
        return alive or bool(entry.queue)

    def step(self) -> bool:
        """One round over every registered app (round-robin by
        construction: each app gets exactly one dispatch+step per
        round)."""
        alive = False
        for app in list(self.apps):
            if app in self.apps:
                alive = self.step_app(app) or alive
        return alive

    def stats(self, app: str) -> Dict:
        entry = self.apps.get(app)
        if entry is None:
            return {}
        return {"queue_len": len(entry.queue),
                "submitted": entry.submitted,
                "dispatched": entry.dispatched,
                "num_replicas": len(entry.rset.replicas),
                "replicas_added": entry.rset.replicas_added,
                "replicas_removed": entry.rset.replicas_removed,
                "max_batch": entry.rset.max_batch}
