"""Front-end request router + replica sets: the scale-out data plane.
The port's copy of ``repro/serving/router.py``.

* :class:`RequestRouter` -- one per pod (``Cluster.router``).  It owns
  one FIFO queue per application and continuously dispatches queued
  requests across the app's replicas, join-shortest-queue among the
  replicas with batch headroom.  Binding is late: a request waits in
  the router queue until some replica can actually grow its continuous
  batch.  Every app has its own queue and its own replicas, and
  ``step()`` services every app each round.

* :class:`ReplicaSet` -- N :class:`ServingEngine` replicas of ONE app,
  each on its own private pool, all feeding the app's one sizing-history
  series; past the first replica the model params are aliased.

Removing a replica drains the victim engine (pages reclaimed) and hands
its requests to a survivor.  Token-identical migration needs one
physical KV array set behind every replica (the pod-shared pool, queue
item A6); until then every runner-backed request falls back to the
at-least-once path: requeued at the router, re-executed from scratch,
still deterministic.  The runtime sanitizer hooks of the reference stay
out (item M9).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import EngineStats, ServingEngine
from repro_torch.serving.kv_cache import Request


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
    set owns replica lifecycle (add / drain-and-remove / batch width), so
    an autoscale controller (a later slice) stays pure control plane.
    """

    def __init__(self, app: str, build: Callable[[int], Replica], *,
                 initial: int = 1):
        self.app = app
        self._build = build
        self._next_idx = 0
        self.replicas: List[Replica] = []
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
        victim.engine.shutdown()        # frees nothing: drained above
        self.replicas_removed += 1
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

    # -- replica-to-replica migration ----------------------------------------
    def _migrate(self, victim: Replica) -> Dict:
        """Hand the victim's work to survivors: queued requests go back to
        the router front; running ones drain (pages reclaimed) and either
        re-grant on the least-loaded survivor or requeue from scratch.  A
        runner moves its drained KV only when it says it can
        (``can_migrate``); the port's runners keep private page arrays,
        so their requests requeue."""
        target = min(self.replicas, key=lambda r: r.load)
        veng, teng = victim.engine, target.engine
        queued = list(veng.queue)
        veng.queue.clear()
        drained = veng.drain()
        migratable = (victim.runner is None
                      or getattr(victim.runner, "can_migrate", False))
        state = (victim.runner.migrate_out(drained)
                 if victim.runner is not None and migratable else None)
        restored: List[Request] = []
        requeued: List[Request] = []
        for req, (g_ids, l_ids) in drained:
            ok = False
            if (migratable
                    and len(teng.running) + len(restored) < teng.max_batch):
                ok = teng.pool.regrant(req, len(g_ids), len(l_ids))
                while not ok:
                    if not teng._reclaim():
                        break
                    ok = teng.pool.regrant(req, len(g_ids), len(l_ids))
            (restored if ok else requeued).append(req)
        if victim.runner is not None and restored:
            target.runner.migrate_in(state, restored)
        teng.running.extend(restored)
        for req in requeued:            # at-least-once fallback
            req.generated = 0
            req.state = "queued"
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
        # primary last, as the reference does (there the primary's view
        # close drops a pod-shared KV store exactly once)
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
