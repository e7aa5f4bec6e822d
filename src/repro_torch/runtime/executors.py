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

This port serves one replica set per app on *private* page pools; what it
does not bring yet raises ``NotImplementedError`` naming the queue item
(``ROADMAP.md``) that brings it: the pod-shared pool and its KV aliasing
(A6), the prefix cache (A3), and a plan on more than one device (a
multi-card slice).
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

SHARED_POOL_LATER = (
    "the pod-shared page pool (ServeOptions.private_pool=False, "
    "Cluster.pod_pool, and the KV aliasing of alias_kv across its tenants) "
    "comes with queue item A6 of the port; pass private_pool=True")
PREFIX_CACHE_LATER = ("the prefix cache (ServeOptions.prefix_cache=True) "
                      "comes with queue item A3 of the port")


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

    @staticmethod
    def check_supported(opts: ServeOptions) -> None:
        """Refuse the serve options this port does not bring yet."""
        if not opts.private_pool:
            raise NotImplementedError(SHARED_POOL_LATER)
        if opts.prefix_cache:
            raise NotImplementedError(PREFIX_CACHE_LATER)

    def _bind_serve(self, handle: "AppHandle") -> None:
        """Serve data plane: a ReplicaSet of engines registered with the
        pod's RequestRouter.  ``exec_state['engine']`` stays the primary
        replica's engine."""
        from repro_torch.serving.router import ReplicaSet
        opts = self.serve_opts(handle)
        self.check_supported(opts)
        rset = ReplicaSet(handle.app.name,
                          lambda idx: self.build_replica(handle, idx),
                          initial=opts.replicas)
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

    def build_pool(self, handle: "AppHandle") -> PagePool:
        """The application's private KV page pool, keyed by the app name
        in the sizing history: every replica feeds one series.  (The
        reference's replica views onto a pod-shared pool come with queue
        item A6.)

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
        return PagePool(pages, history=handle.cluster.history,
                        app=handle.app.name, policy=opts.policy,
                        groups=groups)

    def build_replica(self, handle: "AppHandle", idx: int) -> "Replica":
        from repro_torch.serving.router import Replica
        opts = self.serve_opts(handle)
        eng = ServingEngine(self.build_pool(handle),
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
        mesh = handle.plan.mesh
        if mesh.num_devices > 1:
            raise NotImplementedError(
                f"{handle.app.name}: the plan's mesh {mesh.name!r} has "
                f"{mesh.num_devices} devices; the port binds plans on one "
                "card until a multi-card slice")
        if self.device.type == "cuda":
            import torch
            # the allocator's high-water mark from here on is this app's
            # (with one application a card): ``footprint`` reads it
            handle.exec_state["cuda_base"] = torch.cuda.memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if handle.app.kind == "train":
            self._bind_train(handle)
        else:
            self._bind_serve(handle)

    def _bind_train(self, handle: "AppHandle") -> None:
        import dataclasses

        from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.models.model import Model
        from repro_torch.training import optimizer as opt
        from repro_torch.training.train_step import (impl_from_plan,
                                                     make_train_step)

        app, plan = handle.app, handle.plan
        cfg, shape = app.config, app.shape
        # reduced runs keep remat off: the ladder's remat choice targets
        # the card's HBM budget, not the smoke-scale footprint
        model = Model(cfg, impl_from_plan(
            dataclasses.replace(plan, remat="none") if app.reduced else plan))
        params = self.init_params(handle)
        opt_state = opt.init_opt_state(params)
        key = plan_layout_key(cfg.name, shape.name, plan.mesh.name, plan)
        step = self.cache.get_or_compile(
            key, lambda: make_train_step(model, plan, self.opt_cfg))
        data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                      shape.global_batch))
        ckpt_dir = self.ckpt_path(handle)
        ck = AsyncCheckpointer(ckpt_dir, keep=3) if ckpt_dir else None
        handle.exec_state.update(model=model, params=params,
                                 opt_state=opt_state, step=step, data=data,
                                 checkpointer=ck)
        if self.resume:
            handle.cursor = max(handle.cursor, self.restore(handle))

    # -- accounting -----------------------------------------------------------
    def footprint(self, handle: "AppHandle") -> int:
        """Bytes the app holds on its device: the distinct tensors it
        bound (weights, optimizer state, every replica's KV pages or
        dense cache) and, on CUDA, the allocator's peak since bind
        (activations and temporaries included) when that is larger."""
        st = handle.exec_state
        trees = [st.get("params"), st.get("opt_state")]
        rset = st.get("replicas")
        for rep in (rset.replicas if rset is not None else []):
            store = getattr(rep.runner, "store", None)
            trees += [rep.runner.params, getattr(rep.runner, "cache", None),
                      store and (store.k_pages, store.v_pages)]
        held = _tensor_bytes(trees)
        if "cuda_base" in st:
            import torch
            held = max(held, torch.cuda.max_memory_allocated(self.device)
                       - st["cuda_base"])
        return held

    def account(self, handle: "AppHandle") -> None:
        """Grow the job's grant (``handle.scale_up``, in sizing quanta) to
        the app's ``footprint`` and keep it as the job's high-water mark,
        which the scheduler records in the sizing history when the job
        finishes: the next submission is sized from what the app held on
        the card, not from the estimate it was placed with."""
        from repro_torch.runtime.cluster import SIZING_QUANTUM
        held = self.footprint(handle)
        handle.job.peak_bytes = max(handle.job.peak_bytes, held)
        short = held - handle.job.demand_bytes
        if short > 0:
            handle.scale_up(-(-short // SIZING_QUANTUM) * SIZING_QUANTUM)

    # -- training -----------------------------------------------------------
    def train_step(self, handle: "AppHandle") -> Dict[str, float]:
        import torch

        st = handle.exec_state
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in st["data"].batch_at(handle.cursor).items()}
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
                extra={"cursor": handle.cursor}, block=block)

    def restore(self, handle: "AppHandle") -> int:
        from repro_torch.checkpoint.checkpointer import (latest_step,
                                                         restore_checkpoint)
        ckpt_dir = self.ckpt_path(handle)
        if not ckpt_dir or latest_step(ckpt_dir) is None:
            return 0
        st = handle.exec_state
        tree = {"params": st["params"], "opt": st["opt_state"]}
        restored, extra, _ = restore_checkpoint(ckpt_dir, None, tree)
        st["params"], st["opt_state"] = restored["params"], restored["opt"]
        return int(extra.get("cursor", 0))

    # -- serving ------------------------------------------------------------
    default_pool_pages = 128
    default_max_batch = 4

    def build_replica(self, handle: "AppHandle", idx: int) -> "Replica":
        from repro_torch.serving.model_runner import build_runner
        from repro_torch.serving.router import Replica

        app = handle.app
        opts = self.serve_opts(handle)
        max_batch = opts.max_batch or self.default_max_batch
        # both backends pad decode to the runner's build-time batch, so a
        # batch-scaling policy gets its headroom baked into the runner up
        # front: the engine's admission width then moves within it
        runner_batch = max_batch
        if opts.scale is not None and opts.scale.batch_max is not None:
            runner_batch = max(runner_batch, opts.scale.batch_max)
        pool = self.build_pool(handle)
        prim = handle.exec_state.get("runner")
        # replicas serve one model: alias the primary's weights so a
        # replica costs compute slots, not a second params copy
        params = (prim.params if idx > 0 and prim is not None
                  and prim.backend == opts.backend
                  else self.init_params(handle))
        runner = build_runner(opts.backend, app.config, seed=self.seed,
                              max_batch=runner_batch,
                              cache_len=opts.cache_len,
                              pool_pages=pool.physical_pages,
                              use_rings=opts.swa_rings,
                              chunk_pages=opts.chunk_pages or 4,
                              params=params, device=self.device)
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
