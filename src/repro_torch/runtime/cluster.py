"""Cluster + AppHandle: the single public submission path.  The port's
copy of ``repro/runtime/cluster.py``.

The lifecycle (paper §4-§5)::

    cluster = Cluster(pods=1, mesh=H100, history=...,
                      executor=TorchExecutor())
    handle  = cluster.submit(app)     # size -> place -> materialize -> bind
    handle.run(steps)                 # execute (train loop / serving engine)
    handle.scale_up(bytes)            # runtime data-component growth
    handle.release()                  # free placement, restore capacity

``submit`` performs the platform's side of the resource-centric contract:

1. **sizing** -- proactive profile estimate, refined by the §9.3
   ``solve_init_step`` program over the decayed history of this
   application's past footprints (initial + incremental grant sizes);
2. **placement** -- the two-level scheduler (``GlobalScheduler`` best-fit
   across pods, ``PodScheduler`` component placement within one);
3. **materialization** -- the locality ladder (``materialize``), with
   compile-feedback escalation available via ``handle.escalate``;
4. **execution** -- the bound :class:`~repro_torch.runtime.executors.Executor`
   (NullExecutor for placement only, TorchExecutor for the card).

Insufficient capacity queues the application (``handle.state ==
"pending"``); releasing other applications drains the queue and the
handle binds lazily on its first step.

Not in this port yet, each raising ``NotImplementedError`` with the queue
item that brings it: the pod-shared page pool (``pod_pool``, A6), the
autoscale control plane (``enable_autoscale``, A6) and idle parking
(``park``/``unpark``, A6).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, TYPE_CHECKING, Tuple, Union

from repro_torch.checkpoint.recovery import StragglerWatchdog, elastic_replan
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import (H100, MESHES, MeshSpec, Plan,
                                           escalate, materialize)
from repro_torch.core.scheduler import GlobalScheduler, Job, PodState
from repro_torch.core.sizing import SizingSolution, solve_init_step
from repro_torch.runtime.application import Application
from repro_torch.runtime.executors import (SHARED_POOL_LATER, Executor,
                                           NullExecutor, TorchExecutor)
from repro_torch.serving.kv_cache import Request

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.router import RequestRouter
    from repro_torch.serving.stats import StatsView

AUTOSCALE_LATER = ("the autoscale control plane (enable_autoscale, park, "
                   "unpark) comes with queue item A6 of the port")

GB = 1 << 30
SIZING_QUANTUM = 64 << 20          # 64 MiB allocation granularity


class AppHandle:
    """Live view of one submitted application; drives its lifecycle."""

    def __init__(self, app: Application, job: Job, cluster: "Cluster",
                 sizing: Optional[SizingSolution] = None):
        self.app = app
        self.job = job
        self.cluster = cluster
        self.sizing = sizing
        self.plan: Optional[Plan] = None
        self.exec_state: Dict = {}
        self.bound = False
        self.cursor = 0                 # train steps completed / data cursor
        self.metrics: List[Dict] = []
        self.watchdog = StragglerWatchdog()

    # -- state --------------------------------------------------------------
    @property
    def state(self) -> str:
        return self.job.state

    @property
    def pod(self) -> Optional[str]:
        return self.job.pod

    @property
    def engine(self):
        return self.exec_state.get("engine")

    @property
    def runner(self):
        """The serving backend (ModelRunner) bound to this application."""
        return self.exec_state.get("runner")

    # -- serving data plane (serving/router.py) ------------------------------
    @property
    def replica_set(self):
        """The app's ReplicaSet (None for train/synthetic apps)."""
        return self.exec_state.get("replicas")

    @property
    def num_replicas(self) -> int:
        """Live replica count."""
        rset = self.replica_set
        if rset is None:
            return 1 if self.engine is not None else 0
        return len(rset.replicas)

    def add_replica(self):
        """Scale out by one engine replica (aliased params; on a private
        pool it also costs a second pool's KV pages)."""
        rset = self.replica_set
        if rset is None:
            raise RuntimeError(f"{self.app.name}: no replica set "
                               "(serve applications only)")
        return rset.add_replica()

    def remove_replica(self) -> Dict:
        """Scale in by one replica; its in-flight requests move to a
        survivor (requeued from scratch where the runner cannot migrate
        its KV)."""
        rset = self.replica_set
        if rset is None:
            raise RuntimeError(f"{self.app.name}: no replica set "
                               "(serve applications only)")
        return rset.remove_replica()

    def set_max_batch(self, n: int) -> int:
        """Set the continuous-batch admission width on every replica
        (clamped to the runners' compile-shape cap); returns the width
        actually applied."""
        rset = self.replica_set
        if rset is None:
            raise RuntimeError(f"{self.app.name}: no replica set "
                               "(serve applications only)")
        return rset.set_max_batch(n)

    @property
    def stats_view(self) -> "StatsView":
        """THE stats surface: cumulative | windowed, replica-aggregated
        (see :class:`repro_torch.serving.stats.StatsView`)."""
        from repro_torch.serving.stats import StatsView
        return StatsView(self)

    def _ensure_bound(self) -> None:
        if self.job.state != "running":
            raise RuntimeError(
                f"{self.app.name}: not placed (state={self.job.state}); "
                "release capacity or wait for the pending queue to drain")
        if self.bound or self.app.config is None:
            return
        self.cluster.executor.bind(self)
        self.bound = True
        self.cluster.executor.account(self)

    # -- execution ----------------------------------------------------------
    def step(self) -> Dict:
        """One unit of progress: a train step or one engine iteration."""
        self._ensure_bound()
        if self.app.kind == "train":
            # perf_counter, NOT time.time(): the serving engine stamps
            # submitted_at/TTFT with perf_counter, and trace timestamps
            # must compose with wall measurements on one monotonic clock
            # (time.time() can step backwards under NTP adjustment)
            t0 = time.perf_counter()
            m = self.cluster.executor.train_step(self)
            wall = time.perf_counter() - t0
            self.cursor += 1
            m["wall_s"] = wall
            m["straggled"] = self.watchdog.observe(self.cursor, wall)
            if self.cluster.history is not None:
                self.cluster.history.observe(self.app.config.name, "train",
                                             "step_wall_s", wall)
            self.cluster.executor.maybe_checkpoint(self)
            self.cluster.executor.account(self)
            self.metrics.append(m)
            return m
        rset = self.replica_set
        if rset is not None and rset.router is not None:
            alive = rset.router.step_app(self.app.name)
        else:
            alive = self.engine.step()
        return {"alive": alive, "stats": self.engine.stats}

    def run(self, steps: Optional[int] = None, *,
            max_steps: int = 1_000_000) -> Dict:
        """Run to completion: N train steps, or drain the serving queue."""
        self._ensure_bound()
        if self.app.kind == "train":
            total = steps if steps is not None else int(
                self.app.options.get("steps", 10))
            while self.cursor < total:
                self.step()
            self.cluster.executor.checkpoint(self)
            losses = [m["loss"] for m in self.metrics]
            return {"steps": self.cursor,
                    "loss_first": losses[0] if losses else None,
                    "loss_last": losses[-1] if losses else None,
                    "straggled": len(self.watchdog.flags)}
        rset = self.replica_set
        if rset is None or rset.router is None:
            stats = self.engine.run_to_completion(max_steps=max_steps)
            self.cluster.executor.account(self)
            return stats.as_dict()
        # scale-out path: drain the router queue plus every replica;
        # counters aggregate across replicas so the dict keeps the exact
        # shape (and, for one replica, the exact values) of the old path
        from repro_torch.serving.stats import aggregate_engine_stats
        router = rset.router
        t0 = time.perf_counter()
        steps = 0
        while steps < max_steps and router.step_app(self.app.name):
            steps += 1
        wall = time.perf_counter() - t0
        self.cluster.executor.account(self)
        self.engine.stats.wall_s = wall
        agg = aggregate_engine_stats(self)
        agg.wall_s = wall
        return agg.as_dict()

    def submit_request(self, req: Request) -> None:
        """Enqueue one serving request."""
        self._ensure_bound()
        rset = self.replica_set
        if rset is not None and rset.router is not None:
            rset.router.submit(self.app.name, req)
        else:
            self.engine.submit(req)

    # -- runtime scaling (paper §5.1.2) -------------------------------------
    def scale_up(self, extra_bytes: int) -> bool:
        """Grow this application's footprint (consumes its reservation)."""
        return self.cluster.scheduler.scale_up(self.job, int(extra_bytes))

    def scale_down(self, release_bytes: int) -> int:
        return self.cluster.scheduler.scale_down(self.job, int(release_bytes))

    # -- idle parking (the reference's repro/autoscale) -----------------------
    @property
    def parked(self) -> bool:
        """Always False until idle parking is ported (A6)."""
        return False

    def park(self) -> Dict:
        """Idle reclamation: queue item A6 of the port."""
        raise NotImplementedError(AUTOSCALE_LATER)

    def unpark(self) -> Dict:
        """Warm restart from a parked snapshot: queue item A6 of the
        port."""
        raise NotImplementedError(AUTOSCALE_LATER)

    # -- materialization feedback / recovery --------------------------------
    def _rebind(self) -> None:
        """Drop executable state (quiescing in-flight checkpoints), rebind
        under the current plan, and restore the latest persisted cut."""
        was_bound = self.bound
        self.cluster.executor.release(self)
        self.bound = False
        if was_bound:
            self._ensure_bound()
            self.cursor = self.cluster.executor.restore(self)

    def escalate(self, measured_bytes: int) -> bool:
        """Compile-feedback escalation: move one rung up the ladder."""
        nxt = escalate(self.plan, self.app.config, self.app.shape,
                       measured_bytes)
        if nxt is None:
            return False
        self.plan = nxt
        self._rebind()
        return True

    def checkpoint(self, block: bool = True) -> None:
        self.cluster.executor.checkpoint(self, block=block)

    def recover(self, mesh: Optional[MeshSpec] = None) -> int:
        """Re-materialize (possibly on a different mesh) and restore the
        latest persisted cut.  Returns the restart cursor."""
        mesh = mesh or self.cluster.mesh
        self.plan = elastic_replan(self.app.config, self.app.shape, mesh,
                                   history=self.cluster.history)
        self.bound = True      # recover may be called on a fresh handle too
        self._rebind()
        return self.cursor

    def release(self) -> None:
        self.cluster.release(self)


class Cluster:
    """Resource-centric entry point: owns pods, scheduler, and executor.
    One pod by default (the reference's default is two): the port's mesh
    is one card."""

    def __init__(self, pods: Union[int, List[PodState]] = 1, *,
                 mesh: Union[str, MeshSpec] = H100,
                 history: Optional[HistoryStore] = None,
                 executor: Optional[Executor] = None):
        self.mesh = MESHES[mesh] if isinstance(mesh, str) else mesh
        npods = pods if isinstance(pods, int) else len(pods)
        if npods > 1 and isinstance(executor, TorchExecutor):
            raise NotImplementedError(
                f"a Cluster of {npods} pods with a TorchExecutor: the "
                "executor binds every app on its one card, so each pod "
                "would count that card's bytes again; one pod until a "
                "multi-card slice")
        if isinstance(pods, int):
            pods = [PodState(f"pod{i}", self.mesh.num_devices,
                             self.mesh.hbm_per_device) for i in range(pods)]
        self.scheduler = GlobalScheduler(pods, history)
        self.history = history
        self.executor = executor or NullExecutor()
        self.handles: Dict[str, AppHandle] = {}
        self._job_ids = itertools.count()
        # per-pod front-end request routers, created lazily
        self._routers: Dict[str, "RequestRouter"] = {}

    def pod_pool(self, pod: str, *, default_pages: int = 256):
        """The pod's single shared KV page pool: queue item A6 of the
        port (every serve app binds a private pool until then)."""
        raise NotImplementedError(SHARED_POOL_LATER)

    def router(self, pod: str) -> "RequestRouter":
        """The pod's front-end request router (created lazily).  Every
        serve application placed on ``pod`` registers its ReplicaSet
        here; ``submit_request`` enqueues into the router, which spreads
        admissions across the app's replicas (join-shortest-queue)."""
        from repro_torch.serving.router import RequestRouter
        rt = self._routers.get(pod)
        if rt is None:
            rt = RequestRouter(pod)
            self._routers[pod] = rt
        return rt

    # -- the control plane (the reference's repro/autoscale) ------------------
    def enable_autoscale(self, **controller_kw):
        """The autoscale control plane: queue item A6 of the port."""
        raise NotImplementedError(AUTOSCALE_LATER)

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One control-plane reconcile round: a no-op until the autoscale
        control plane is ported (``enable_autoscale``)."""
        return []

    # -- sizing (paper §9.3) -------------------------------------------------
    def size(self, app: Application) -> Tuple[int, Optional[SizingSolution]]:
        """Initial footprint: history-solved init when available, else the
        proactive profile estimate; always capped by @app_limit."""
        demand = app.estimate_demand()
        sol = None
        if self.history is not None:
            h = self.history.get(app.name, "job", "bytes")
            if h is not None and h.count:
                sol = solve_init_step(h.samples(),
                                      quantum=float(SIZING_QUANTUM))
                if sol.feasible and sol.init > 0:
                    demand = max(int(sol.init), app.structural_floor())
        return app.capped_demand(demand), sol

    # -- lifecycle ----------------------------------------------------------
    def submit(self, app: Application, *,
               overrides: Optional[Dict] = None) -> AppHandle:
        demand, sizing = self.size(app)
        job = Job(f"job{next(self._job_ids)}", app.name, app.kind,
                  demand, app.demand_chips)
        handle = AppHandle(app, job, self, sizing=sizing)
        self.scheduler.submit(job)
        if app.config is not None:
            handle.plan = materialize(app.config, app.shape, self.mesh,
                                      history=self.history,
                                      overrides=overrides)
            if job.state == "running":
                try:
                    handle._ensure_bound()
                except Exception:
                    # bind failed (e.g. duplicate serve name, unsupported
                    # backend): the placed job would otherwise hold pod
                    # bytes forever with no handle to release it through
                    handle.exec_state.clear()
                    self.scheduler.finish(job)
                    raise
        self.handles[job.job_id] = handle
        return handle

    def release(self, handle: AppHandle) -> None:
        if handle.job.state == "pending":
            self.scheduler.cancel(handle.job)
        elif handle.job.state == "running":
            self.executor.release(handle)
            self.scheduler.finish(handle.job)
        handle.bound = False
        self.handles.pop(handle.job.job_id, None)

    # -- introspection -------------------------------------------------------
    def capacity(self) -> Dict[str, Dict[str, int]]:
        """Exact per-pod accounting snapshot (free / reserved / running)."""
        return {name: {"free_bytes": ps.pod.free_bytes,
                       "reserved_bytes": ps.pod.reserved_bytes,
                       "running": len(ps.pod.running)}
                for name, ps in self.scheduler.pods.items()}

    @property
    def running(self) -> List[AppHandle]:
        return [h for h in self.handles.values() if h.state == "running"]

    @property
    def pending(self) -> List[AppHandle]:
        return [h for h in self.handles.values() if h.state == "pending"]
