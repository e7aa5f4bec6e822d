"""Cluster + AppHandle: the single public submission path.  The port's
copy of ``repro/runtime/cluster.py``.

The lifecycle (paper §4-§5)::

    cluster = Cluster(pods=1, mesh=H100, history=...,
                      executor=TorchExecutor())
    handle  = cluster.submit(app)     # size -> place -> materialize -> bind
    handle.run(steps)                 # execute (train loop / serving engine)
    handle.scale_up(bytes)            # runtime data-component growth
    handle.park()                     # idle reclamation (KV and weights
                                      #   -> host, pages + bytes released)
    cluster.tick()                    # autoscale reconcile round
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

Each pod has one shared KV page pool (``pod_pool``, created lazily and
sized by ``pool_pages`` or its first tenant), which serve apps draw
from through views unless they ask for a private pool.  The autoscale
control plane (``repro_torch.autoscale``) is opt-in through
``enable_autoscale`` and driven by ``tick``; a parked serve app
(``park``) is unparked transparently by its next ``submit_request`` or
``run``.
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
from repro_torch.runtime.executors import (Executor, NullExecutor,
                                           TorchExecutor)
from repro_torch.serving.kv_cache import Request

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.router import RequestRouter
    from repro_torch.serving.stats import StatsView
    from repro_torch.serving.tenancy import SharedPagePool

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
        """Live replica count (0 while parked: park scales to zero)."""
        if self.parked:
            return 0
        rset = self.replica_set
        if rset is None:
            return 1 if self.engine is not None else 0
        return len(rset.replicas)

    def add_replica(self):
        """Scale out by one engine replica (shared KV page tensors and
        params: the cost is compute slots, not memory)."""
        rset = self.replica_set
        if rset is None:
            raise RuntimeError(f"{self.app.name}: no replica set "
                               "(serve applications only)")
        if self.parked:
            raise RuntimeError(f"{self.app.name}: unpark before scaling "
                               "out (a parked app has zero replicas)")
        return rset.add_replica()

    def remove_replica(self) -> Dict:
        """Scale in by one replica; its in-flight requests migrate
        token-identically to a survivor (or requeue where the runner
        cannot migrate its KV)."""
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

    def serving_stats(self, since: Optional[Dict] = None) -> Dict:
        """The controller's read of :attr:`stats_view`:
        ``serving_stats()`` is ``stats_view.cumulative()`` (a valid window
        marker), ``serving_stats(since=marker)`` is
        ``stats_view.windowed(marker)``."""
        view = self.stats_view
        if since is None:
            return view.cumulative()
        return view.windowed(since)

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
        """One unit of progress: a train step or one engine iteration.
        A parked serve app makes no progress (park drained it); submit a
        request or call ``unpark()`` to resume."""
        self._ensure_bound()
        if self.app.kind == "serve" and self.parked:
            return {"alive": False, "stats": self.engine.stats,
                    "parked": True}
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
        if self.parked:
            self.unpark()
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
        """Enqueue one serving request; a parked application is
        transparently unparked first (the paper's warm restart: the
        request lands on a live engine with its KV state restored)."""
        self._ensure_bound()
        if self.parked:
            self.unpark()
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

    # -- idle parking (repro_torch.autoscale) ---------------------------------
    @property
    def parked(self) -> bool:
        return self.exec_state.get("parked") is not None

    def park(self) -> Dict:
        """Reclaim this idle serve app's resources: weights and KV to the
        host (checkpointer array format), pool pages and scheduler bytes
        released.  Returns the reclamation receipt."""
        from repro_torch.autoscale.parking import park_app
        return park_app(self)

    def unpark(self) -> Dict:
        """Warm restart from a parked snapshot (also triggered
        implicitly by ``submit_request``/``run``)."""
        from repro_torch.autoscale.parking import unpark_app
        return unpark_app(self)

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
    One pod by default (the reference's default is two): a pod is one
    mesh (one card, or ``H100X4``'s four), and a ``TorchExecutor`` binds
    on its own host's cards."""

    def __init__(self, pods: Union[int, List[PodState]] = 1, *,
                 mesh: Union[str, MeshSpec] = H100,
                 history: Optional[HistoryStore] = None,
                 executor: Optional[Executor] = None,
                 pool_pages: Optional[int] = None):
        self.mesh = MESHES[mesh] if isinstance(mesh, str) else mesh
        npods = pods if isinstance(pods, int) else len(pods)
        if npods > 1 and isinstance(executor, TorchExecutor):
            raise NotImplementedError(
                f"a Cluster of {npods} pods with a TorchExecutor: the "
                "executor binds every app on its own host's cards, so each "
                "pod would count those cards' bytes again; one pod until the "
                "multi-card slice of ROADMAP item A8d")
        if isinstance(pods, int):
            pods = [PodState(f"pod{i}", self.mesh.num_devices,
                             self.mesh.hbm_per_device) for i in range(pods)]
        self.scheduler = GlobalScheduler(pods, history)
        self.history = history
        self.executor = executor or NullExecutor()
        self.handles: Dict[str, AppHandle] = {}
        self._job_ids = itertools.count()
        # per-pod physical KV pools (multi-tenant serving); sized by
        # ``pool_pages`` when given, else by the first tenant's request
        self.pool_pages = pool_pages
        self._pod_pools: Dict[str, "SharedPagePool"] = {}
        # per-pod front-end request routers, created lazily
        self._routers: Dict[str, "RequestRouter"] = {}
        # the autoscale control plane (repro_torch.autoscale); opt-in via
        # enable_autoscale(), driven by tick()
        self.autoscaler = None

    def pod_pool(self, pod: str, *, default_pages: int = 256
                 ) -> "SharedPagePool":
        """The pod's single shared KV page pool (created lazily).  Every
        serve application placed on ``pod`` gets a quota/weight view onto
        this one physical pool unless it opts into a private pool."""
        from repro_torch.serving.tenancy import SharedPagePool
        sp = self._pod_pools.get(pod)
        if sp is None:
            sp = SharedPagePool(self.pool_pages or default_pages,
                                history=self.history)
            self._pod_pools[pod] = sp
        return sp

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

    # -- the control plane (repro_torch.autoscale) ---------------------------
    def enable_autoscale(self, *, ttft_target_s: Optional[float] = None,
                         denial_target_per_s: float = 0.5,
                         idle_park_s: float = 60.0, **controller_kw):
        """Turn on the autoscale control plane.  Every serve application
        (already running or submitted later) is attached with the stock
        policy chain -- idle parking, target tracking on TTFT/denial-rate,
        and pod-level quota rebalancing -- unless ``make_policies``
        overrides it.  Drive it with ``tick()``."""
        from repro_torch.autoscale.controller import AutoscaleController
        from repro_torch.autoscale.policy import default_policies
        if "make_policies" not in controller_kw:
            def _mk(handle=None):
                # per-app chain: a ScalePolicy on the app's ServeOptions
                # adds replica/batch scalers + predictive unpark
                scale = None
                if handle is not None and handle.app.serve_options is not None:
                    scale = handle.app.serve_options.scale
                return default_policies(
                    ttft_target_s=ttft_target_s,
                    denial_target_per_s=denial_target_per_s,
                    idle_park_s=idle_park_s,
                    scale=scale)
            controller_kw["make_policies"] = _mk
        self.autoscaler = AutoscaleController(self, **controller_kw)
        for h in self.handles.values():
            self.autoscaler.attach(h)
        return self.autoscaler

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """One control-plane reconcile round (no-op until
        ``enable_autoscale``).  ``now`` is injectable for event-driven
        replay; defaults to the wall clock."""
        if self.autoscaler is None:
            return []
        return self.autoscaler.tick(now)

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
        if self.autoscaler is not None:
            self.autoscaler.attach(handle)
        return handle

    def release(self, handle: AppHandle) -> None:
        if self.autoscaler is not None:
            self.autoscaler.detach(handle)
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
