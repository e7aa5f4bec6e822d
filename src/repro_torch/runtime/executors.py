"""Execution backends for the runtime: the simulator and the card share
ONE submission path and differ only in the executor bound at submit time.
The port's copy of ``repro/runtime/executors.py``.

* :class:`NullExecutor` -- no model, no device state.  Training steps are
  no-ops and serving engines run without step functions: placement,
  admission and paging behaviour only.
* :class:`TorchExecutor` -- the counterpart of the reference's
  ``JaxExecutor``: builds the model, caches the train step of the plan in
  the :class:`CompileCache`, feeds synthetic data, writes async
  checkpoints, and serves through the port's runners and engine, on CUDA
  unless the caller asks for the CPU.

Executors keep all per-application state on ``handle.exec_state`` so one
executor instance can drive many applications on one cluster.

A serve app's pool is a view of the pod's shared page pool by default
(``private_pool=True`` gives it a private pool); same-shape paged tenants
and an app's replicas alias one ``KVArrayStore`` and, with
``prefix_cache=True``, one pod-global prefix cache.

``TorchExecutor`` binds a training plan on a mesh of several devices
inside a ``torch.distributed`` world of that many ranks (``torchrun``,
or ranks spawned with a ``file://`` rendezvous): every rank submits the
same application to the same one-pod ``Cluster``, binds its block of
the plan's layouts (``sharding.planner``) on its own card, and runs the
sharded train step; the footprint is the largest of the ranks', so
every rank's control plane takes the same decisions, and rank 0 alone
writes checkpoints.  Outside such a world, and for serving, a
multi-card plan is refused with ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, TYPE_CHECKING

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.compile_cache import CompileCache, plan_layout_key
from repro_torch.runtime.options import ServeOptions
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PageGroups, PagePool

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.runtime.cluster import AppHandle
    from repro_torch.serving.router import Replica

DEFAULT_POOL_PAGES = 256


class Executor:
    """Interface the AppHandle lifecycle drives."""

    name = "null"
    default_pool_pages = DEFAULT_POOL_PAGES
    default_max_batch = 8

    def bind(self, handle: "AppHandle") -> None:
        """Materialize executable state for a placed application."""
        if handle.app.kind == "serve":
            self._bind_serve(handle)

    @staticmethod
    def serve_opts(handle: "AppHandle") -> ServeOptions:
        """The app's typed serve surface (the defaults when an
        Application was built without one)."""
        return handle.app.serve_options or ServeOptions()

    def _bind_serve(self, handle: "AppHandle") -> None:
        """Serve data plane: a ReplicaSet of engines registered with the
        pod's RequestRouter.  ``exec_state['engine']`` stays the primary
        replica's engine."""
        from repro_torch.serving.router import ReplicaSet
        opts = self.serve_opts(handle)
        rset = ReplicaSet(handle.app.name,
                          lambda idx: self.build_replica(handle, idx),
                          initial=opts.replicas, app_weight=opts.weight,
                          quota_pages=opts.quota_pages
                          if isinstance(opts.quota_pages, int) else None)
        try:
            handle.cluster.router(handle.pod).register(handle.app.name, rset)
        except Exception:
            rset.shutdown()
            raise
        handle.exec_state["replicas"] = rset
        handle.exec_state["engine"] = rset.primary.engine

    def train_step(self, handle: "AppHandle") -> Dict[str, float]:
        return {"loss": 0.0}

    def account(self, handle: "AppHandle") -> None:
        """Bring the job's grant up to what the app holds on its device.
        Binds no device here, so there is nothing to account."""

    def build_pool(self, handle: "AppHandle",
                   view_name: Optional[str] = None) -> PagePool:
        """The application's KV page pool.

        Default: a quota/weight-scoped view onto the pod's single
        ``SharedPagePool`` (``serving/tenancy.py``), so every serve app
        placed on one pod draws from one physical pool (the paper's
        resource sharing).  ``ServeOptions.private_pool`` opts out into
        one pool per app, provisioned for its peak.

        Replica views carry suffixed names (``view_name``) but one
        per-app ``history_key``, so N replicas feed one sizing-history
        series.

        When the app serves through the paged backend on a mixed
        global/sliding-window stack, the pool carries the model's
        :class:`PageGroups`, so local layers are charged a bounded ring
        instead of the growing table (``swa_rings=False`` opts out)."""
        opts = self.serve_opts(handle)
        pages = int(opts.pool_pages or self.default_pool_pages)
        groups = None
        if (opts.backend == "paged" and handle.app.config is not None
                and opts.swa_rings):
            g = PageGroups.from_config(handle.app.config)
            groups = g if g.local_layers else None
        if opts.private_pool:
            return PagePool(pages, history=handle.cluster.history,
                            app=handle.app.name, policy=opts.policy,
                            groups=groups)
        shared = handle.cluster.pod_pool(handle.pod, default_pages=pages)
        return shared.view(view_name or handle.app.name,
                           quota=opts.quota_pages, weight=opts.weight,
                           policy=opts.policy, groups=groups,
                           history_key=handle.app.name)

    def build_replica(self, handle: "AppHandle", idx: int) -> "Replica":
        from repro_torch.serving.router import Replica, replica_view_name
        opts = self.serve_opts(handle)
        pool = self.build_pool(
            handle, view_name=replica_view_name(handle.app.name, idx))
        eng = ServingEngine(pool,
                            max_batch=opts.max_batch or self.default_max_batch,
                            history=handle.cluster.history)
        return Replica(idx, eng)

    def maybe_checkpoint(self, handle: "AppHandle") -> None:
        pass

    def checkpoint(self, handle: "AppHandle", block: bool = True) -> None:
        pass

    def restore(self, handle: "AppHandle") -> int:
        """Restore the latest persisted cut; returns the restart cursor."""
        return 0

    def release(self, handle: "AppHandle") -> None:
        rset = handle.exec_state.get("replicas")
        if rset is not None:
            handle.cluster.router(handle.pod).unregister(handle.app.name)
            rset.shutdown()
        handle.exec_state.clear()


class NullExecutor(Executor):
    """Placement/accounting only: binds no device state, so it places on
    any mesh."""


class TorchExecutor(Executor):
    """Execution on the card: the train step of the plan, model-backed
    serving.  ``device`` is resolved here (``resolve_device``): CUDA
    unless the caller passes ``device="cpu"``, and with no CUDA device and
    no explicit CPU request the constructor raises."""

    name = "torch"

    def __init__(self, *, device: DeviceLike = None, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 resume: bool = False, opt_cfg: Optional[Any] = None,
                 compile_cache: Optional[CompileCache] = None):
        self.device = resolve_device(device)
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.resume = resume
        self.opt_cfg = opt_cfg
        self.cache = compile_cache or CompileCache()
        # job ids of the apps bound on this executor's card: the
        # allocator's peak is one app's only while it is alone there
        self.bound_jobs: set = set()

    def ckpt_path(self, handle: "AppHandle") -> Optional[str]:
        """Per-application checkpoint namespace: one executor drives many
        applications, which must not overwrite each other's cuts."""
        if not self.ckpt_dir:
            return None
        return os.path.join(self.ckpt_dir, handle.app.name.replace("/", "_"))

    def init_params(self, handle: "AppHandle"):
        """The weights an application binds with: random from ``seed`` on
        the executor's device.  A parity run overrides this to bridge in
        the reference's weights."""
        from repro_torch.models.model import init_params
        return init_params(handle.app.config, self.seed, self.device)

    # -- binding ------------------------------------------------------------
    def bind(self, handle: "AppHandle") -> None:
        if handle.plan.mesh.num_devices > 1:
            self._join_mesh(handle)
        if self.device.type == "cuda":
            import torch
            # the allocator's high-water mark from here on is this app's
            # while it is the card's only one: ``footprint`` reads it
            handle.exec_state["cuda_base"] = torch.cuda.memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.bound_jobs.add(handle.job.job_id)
        if handle.app.kind == "train":
            self._bind_train(handle)
        else:
            self._bind_serve(handle)

    def _join_mesh(self, handle: "AppHandle") -> None:
        """Lay the plan's mesh over the current ``torch.distributed``
        world and move this executor to the rank's device, or refuse."""
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import TorchMesh, rank_device
        mesh = handle.plan.mesh
        world = dist.get_world_size() if dist.is_initialized() else None
        if handle.app.kind != "train" or world != mesh.num_devices:
            where = ("no torch.distributed world" if world is None
                     else f"a world of {world} ranks")
            raise NotImplementedError(
                f"{handle.app.name}: the plan's mesh {mesh.name!r} has "
                f"{mesh.num_devices} devices; the port binds a multi-card "
                f"plan for training only, inside a world of "
                f"{mesh.num_devices} ranks (here: {handle.app.kind}, "
                f"{where}); launch it with torchrun --nproc-per-node "
                f"{mesh.num_devices} -m repro_torch.launch.train --mesh "
                f"{mesh.name}")
        self.device = rank_device(self.device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        handle.exec_state["mesh"] = TorchMesh(mesh)

    def _bind_train(self, handle: "AppHandle") -> None:
        import dataclasses

        from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.models.model import Model, check_trainable
        from repro_torch.training import optimizer as opt
        from repro_torch.sharding.collectives import tensor_parallel
        from repro_torch.training.train_step import (impl_from_plan,
                                                     layouts_of,
                                                     make_train_step,
                                                     shard_state)

        app, plan = handle.app, handle.plan
        cfg, shape = app.config, app.shape
        check_trainable(cfg)         # before any weights are made
        mesh = handle.exec_state.get("mesh")
        tp = tensor_parallel(mesh) if mesh is not None and plan.tp else None
        # reduced runs keep remat off: the ladder's remat choice targets
        # the card's HBM budget, not the smoke-scale footprint
        model = Model(cfg, impl_from_plan(
            dataclasses.replace(plan, remat="none") if app.reduced else plan),
            tp=tp)
        params = self.init_params(handle)
        layouts = None
        if mesh is None:
            opt_state = opt.init_opt_state(params)
        else:
            layouts = layouts_of(model, plan, mesh)
            params, opt_state = shard_state(params, layouts)
        key = plan_layout_key(cfg.name, shape.name, plan.mesh.name, plan)
        step = self.cache.get_or_compile(
            key, lambda: make_train_step(model, plan, self.opt_cfg, mesh))
        data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                      shape.global_batch))
        ckpt_dir = self.ckpt_path(handle)
        ck = AsyncCheckpointer(ckpt_dir, keep=3) if ckpt_dir else None
        handle.exec_state.update(model=model, params=params,
                                 opt_state=opt_state, step=step, data=data,
                                 checkpointer=ck, layouts=layouts)
        if self.resume:
            handle.cursor = max(handle.cursor, self.restore(handle))

    # -- accounting -----------------------------------------------------------
    def footprint(self, handle: "AppHandle") -> int:
        """Bytes the app holds on its device: the distinct tensors it
        bound (weights, optimizer state, every replica's KV pages or
        dense cache; on a mesh, the largest rank's) and, on CUDA, the
        allocator's peak since bind
        (activations and temporaries included) when that is larger and
        the app is the only one bound on the card -- with a co-tenant the
        peak holds the co-tenant's allocations too, so only the tensors
        count.  A parked app holds nothing: its weights and KV are on
        the host, and a store it shares is its active co-tenants'."""
        if handle.parked:
            return 0
        st = handle.exec_state
        trees = [st.get("params"), st.get("opt_state")]
        rset = st.get("replicas")
        for rep in (rset.replicas if rset is not None else []):
            store = getattr(rep.runner, "store", None)
            trees += [rep.runner.params, getattr(rep.runner, "cache", None),
                      store and (store.k_pages, store.v_pages)]
        held = _tensor_bytes(trees)
        if "cuda_base" in st and self.bound_jobs == {handle.job.job_id}:
            import torch
            held = max(held, torch.cuda.max_memory_allocated(self.device)
                       - st["cuda_base"])
        mesh = st.get("mesh")
        if mesh is not None:
            # every rank's control plane must grant, record and escalate
            # alike: the largest rank's footprint
            import torch
            import torch.distributed as dist
            t = torch.tensor([held], dtype=torch.int64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.world)
            held = int(t.item())
        return held

    def account(self, handle: "AppHandle") -> None:
        """Grow the job's grant (``handle.scale_up``, in sizing quanta) to
        the app's ``footprint`` and keep it as the job's high-water mark,
        which the scheduler records in the sizing history when the job
        finishes: the next submission is sized from what the app held on
        the card, not from the estimate it was placed with.  A parked app
        holds nothing, so its grant (the scheduler's park reservation,
        which its unpark reacquires exactly) is left as it is."""
        from repro_torch.runtime.cluster import SIZING_QUANTUM
        held = self.footprint(handle)
        handle.job.peak_bytes = max(handle.job.peak_bytes, held)
        short = held - handle.job.demand_bytes
        if short > 0:
            handle.scale_up(-(-short // SIZING_QUANTUM) * SIZING_QUANTUM)

    # -- training -----------------------------------------------------------
    def train_step(self, handle: "AppHandle") -> Dict[str, float]:
        import torch

        from repro_torch.data.pipeline import rank_rows
        st = handle.exec_state
        batch = st["data"].batch_at(handle.cursor)
        if st.get("layouts") is not None:
            batch = rank_rows(batch, *st["layouts"].batch.part(0))
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}
        st["params"], st["opt_state"], m = st["step"](
            st["params"], st["opt_state"], batch)
        return {k: float(v) for k, v in m.items()}     # waits for the step

    def maybe_checkpoint(self, handle: "AppHandle") -> None:
        if (self.ckpt_every and handle.exec_state.get("checkpointer")
                and handle.cursor % self.ckpt_every == 0):
            self.checkpoint(handle, block=False)

    def checkpoint(self, handle: "AppHandle", block: bool = True) -> None:
        ck = handle.exec_state.get("checkpointer")
        if ck is None:
            return
        st = handle.exec_state
        ck.save(handle.cursor, {"params": st["params"], "opt": st["opt_state"]},
                extra={"cursor": handle.cursor}, block=block,
                layouts=_state_layouts(st))

    def restore(self, handle: "AppHandle") -> int:
        from repro_torch.checkpoint.checkpointer import (latest_step,
                                                         restore_checkpoint)
        ckpt_dir = self.ckpt_path(handle)
        if not ckpt_dir or latest_step(ckpt_dir) is None:
            return 0
        st = handle.exec_state
        tree = {"params": st["params"], "opt": st["opt_state"]}
        restored, extra, _ = restore_checkpoint(ckpt_dir, None, tree,
                                                shardings=_state_layouts(st))
        st["params"], st["opt_state"] = restored["params"], restored["opt"]
        return int(extra.get("cursor", 0))

    # -- serving ------------------------------------------------------------
    default_pool_pages = 128
    default_max_batch = 4

    def build_replica(self, handle: "AppHandle", idx: int) -> "Replica":
        from repro_torch.serving.model_runner import (KVArrayStore,
                                                      PagedRunner,
                                                      build_runner,
                                                      kv_shape_key)
        from repro_torch.serving.prefix_cache import PrefixCache
        from repro_torch.serving.router import Replica, replica_view_name

        app = handle.app
        opts = self.serve_opts(handle)
        max_batch = opts.max_batch or self.default_max_batch
        # both backends pad decode to the runner's build-time batch, so a
        # batch-scaling policy gets its headroom baked into the runner up
        # front: the engine's admission width then moves within it
        runner_batch = max_batch
        if opts.scale is not None and opts.scale.batch_max is not None:
            runner_batch = max(runner_batch, opts.scale.batch_max)
        pool = self.build_pool(
            handle, view_name=replica_view_name(app.name, idx))
        try:
            prim = handle.exec_state.get("runner")
            # replicas serve one model: alias the primary's weights so a
            # replica costs compute slots, not a second params copy.  The
            # weights come before the page tensors, so that their init's
            # temporaries do not stack on a store already held
            params = (prim.params if idx > 0 and prim is not None
                      and prim.backend == opts.backend
                      else self.init_params(handle))
            kv_store = None
            if (opts.backend == "paged"
                    and getattr(pool, "shared", None) is not None
                    and opts.alias_kv
                    and all(k in PagedRunner.SUPPORTED_KINDS
                            for k in app.config.pattern)):
                # physical aliasing: every same-KV-shape paged tenant on
                # this pod -- and every replica of one app -- reads and
                # writes ONE set of page tensors, keyed by shape
                # (mismatched shapes get their own store; alias_kv=False
                # opts out)
                key = kv_shape_key(app.config, pool.physical_pages,
                                   use_rings=opts.swa_rings)
                kv_store = pool.shared.kv_store(
                    key, lambda: KVArrayStore(key, self.device))
                pool.bind_kv_store(kv_store)
            prefix_cache = None
            if opts.prefix_cache:
                if kv_store is not None:
                    # pod-global cache keyed by (kv shape, model, seed):
                    # same-weights tenants share cached prefixes, and the
                    # cache's pages return to the POD free list
                    ck = (kv_store.key, app.config.name, self.seed)
                    shared = pool.shared
                    prefix_cache = shared.prefix_cache(
                        ck, lambda: PrefixCache(ck, shared._give))
                    prefix_cache.users.add(app.name)
                else:
                    # a private pool (or an unaliased tenant) keeps a
                    # private cache; evicted pages return to the free
                    # list that granted them: the pod's for a view, the
                    # pool's own otherwise
                    shared = getattr(pool, "shared", None)
                    free_fn = (shared._give if shared is not None
                               else pool._give)
                    prefix_cache = PrefixCache(
                        (None, app.config.name, self.seed), free_fn)
                pool.prefix_cache = prefix_cache
            runner = build_runner(opts.backend, app.config, seed=self.seed,
                                  max_batch=runner_batch,
                                  cache_len=opts.cache_len,
                                  pool_pages=pool.physical_pages,
                                  use_rings=opts.swa_rings,
                                  kv_store=kv_store,
                                  prefix_cache=prefix_cache,
                                  chunk_pages=opts.chunk_pages or 4,
                                  params=params, device=self.device)
        except Exception:
            # the pool view is already registered on the pod: an orphan
            # would dilute every tenant's fair share (close also unbinds
            # the kv store, dropping it with its last user)
            close = getattr(pool, "close", None)
            if close is not None:
                close()
            raise
        eng = ServingEngine(pool, max_batch=max_batch, runner=runner,
                            history=handle.cluster.history)
        if idx == 0:
            handle.exec_state.update(model=getattr(runner, "model", None),
                                     params=runner.params, runner=runner)
        return Replica(idx, eng, runner=runner)

    def release(self, handle: "AppHandle") -> None:
        if handle.exec_state:
            self.account(handle)
        ck = handle.exec_state.get("checkpointer")
        if ck is not None:
            ck.wait()
        super().release(handle)
        self.bound_jobs.discard(handle.job.job_id)


def _state_layouts(st: Dict) -> Optional[Dict]:
    """The layouts of a sharded train app's checkpoint tree ({"params",
    "opt"}), or None on one card."""
    lay = st.get("layouts")
    if lay is None:
        return None
    from repro_torch.sharding.planner import Layout
    return {"params": lay.params,
            "opt": {"m": lay.opt, "v": lay.opt, "master": lay.opt,
                    "count": Layout(st["mesh"], ())}}


def _tensor_bytes(trees) -> int:
    """Bytes of the distinct tensor storages under ``trees`` (nested
    dicts, lists and tuples; a storage shared by two leaves counts
    once)."""
    import torch
    storages, stack = {}, [trees]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            s = x.untyped_storage()
            storages[s.data_ptr()] = s.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return sum(storages.values())
