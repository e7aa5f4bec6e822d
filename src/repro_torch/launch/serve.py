"""Serve an architecture on one of the port's backends, through the
resource-centric runtime.

Counterpart of ``repro/launch/serve.py``: it describes the serving
application and submits it to a one-pod ``Cluster`` on the card's mesh
(``H100``) with a :class:`TorchExecutor`; the cluster sizes it from the
history store (§9.3), places it (two-level scheduler), materializes it
(locality ladder) and binds its engine replicas, by default on a view of
the pod's shared page pool with the pod's KV page tensors for its shape
(``--private-pool`` gives it a pool of its own, ``--no-alias-kv`` tensors
of its own), and, with ``--prefix-cache``, the pod's prefix cache.  The
requests go through the handle (``submit_request`` -> the pod's router ->
the replicas' engines) and ``handle.run()`` drains them.  The paged
backend serves RoPE attention stacks; the dense backend also serves the
Mamba-2, RWKV-6 and zamba2 hybrid stacks.  Runs on CUDA unless
``device="cpu"`` is asked for; with no CUDA device and no explicit CPU
request it raises.

The invocation class submitted is a decode shape of ``max_batch`` lanes
by the cache length the traffic is served with (``DENSE_CACHE_LEN`` on
the dense backend, the pool's tokens per lane on the paged one): the
reference's default serve shape, ``decode_32k`` (128 x 32768), does not
fit one card for tinyllama-1.1b or zamba2-2.7b.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b
    python -m repro_torch.launch.serve --arch zamba2-2.7b --backend dense
    python -m repro_torch.launch.serve --reduced --device cpu --requests 4
    python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --prefix-cache --shared-prefix 1500 --prompt-min 1564 \
        --prompt-max 2012 --pool-pages 192

On a mesh of several cards (``--mesh h100x4``: (2, 2) over ``("data",
"model")``) every rank runs this same program, as ``launch.train``'s
ranks do: it joins the ``torch.distributed`` world (``--dist-backend``,
NCCL by default, from ``torchrun``'s environment), submits the same
application to the same one-pod ``Cluster``, and the executor serves it
on the dense backend with the rank's blocks of the weights and the cache
under the ladder's plan (tensor parallel over ``model``, an MoE stack's
experts expert-parallel over it, the lanes over ``data``); every rank's
engine holds the same requests and tokens, and only rank 0 prints and
saves the sizing history.  Every family that serves prompts of tokens
serves so, the backend dense by default there; under a plan with FSDP
(weight-gathered serving: full-depth dbrx-132b's on ``h100x4``, whose
245.1 GiB of bf16 weights no card holds under TP + EP alone) each rank
stores its slices split over 'data' as well and gathers each block for
its forward.  whisper-base serves on a mesh through ``Model.prefill`` /
``decode_step`` with its encoder's frames (``enc_feats``), not through
this launcher; the paged backend on a mesh is refused (ROADMAP item
A8d)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --mesh h100x4 --backend dense --arch command-r-35b
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --mesh h100x4 --backend dense --arch qwen2-moe-a2.7b
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --mesh h100x4 --arch dbrx-132b

``--shared-prefix N`` (this port's own; the reference sets prompt overlap
with explicit ``prompt_tokens``) gives every synthetic prompt the same
first N tokens, as a service whose requests all begin with one system
prompt sends them.

The reference's control-plane and observability flags:

* ``--autoscale`` turns the autoscale control plane on and serves the
  requests in two bursts: the first half, then 6 idle ticks of an
  injected clock (one a second) under ``idle_park_s=3.0``, in which the
  idle parker parks the app (weights and KV to the host), then the
  second half, whose first request unparks it transparently;
* ``--max-replicas N`` lets the controller move the replica count up to
  N (a ``ScalePolicy``);
* ``--trace PATH`` records the request-lifecycle trace and writes it
  (``.jsonl``: one event a line; else Chrome/Perfetto trace JSON), which
  ``python -m repro_torch.obs PATH`` summarizes;
* ``--metrics-dump`` records the latency histograms and prints their
  Prometheus exposition at the end; ``--metrics-port P`` serves it at
  ``http://127.0.0.1:P/metrics`` while the run lasts (0: any free port).

    python -m repro_torch.launch.serve --reduced --device cpu \
        --autoscale --trace /tmp/t.json
    python -m repro_torch.obs /tmp/t.json
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch.distributed as dist

from repro_torch import DeviceLike, obs
from repro_torch.configs import ShapeConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import MESHES, MeshSpec
from repro_torch.launch.mesh import init_world
from repro_torch.runtime import (Application, Cluster, ScalePolicy,
                                 ServeOptions, TorchExecutor)
from repro_torch.serving.kv_cache import PAGE_SIZE, Request

# the dense backend's cache per slot: a 1024-token prompt and its new
# tokens fit (zamba2-2.7b's context is 4096; rwkv6-7b keeps no KV)
DENSE_CACHE_LEN = 2048


def serve_shape(backend: str, max_batch: int, pool_pages: int
                ) -> ShapeConfig:
    """The decode invocation class of the traffic: ``max_batch`` lanes by
    the cache length each lane is served with."""
    cache = (DENSE_CACHE_LEN if backend == "dense"
             else pool_pages * PAGE_SIZE // max_batch)
    return ShapeConfig(f"decode_{cache}x{max_batch}", "decode", cache,
                       max_batch)


def submit_app(cluster: Cluster, arch: str, *, backend: str = "paged",
               reduced: bool = False, max_batch: int = 8,
               pool_pages: int = 128, policy: str = "history",
               private_pool: bool = False, alias_kv: bool = True,
               prefix_cache: bool = False, replicas: int = 1,
               chunk_pages: Optional[int] = None,
               scale: Optional[ScalePolicy] = None,
               name: Optional[str] = None):
    """Submit one serving application of ``arch`` to ``cluster`` at the
    traffic's decode shape (:func:`serve_shape`); returns its handle,
    which must be running."""
    opts = ServeOptions(backend=backend, max_batch=max_batch,
                        cache_len=DENSE_CACHE_LEN, pool_pages=pool_pages,
                        policy=policy, private_pool=private_pool,
                        alias_kv=alias_kv, prefix_cache=prefix_cache,
                        replicas=replicas, chunk_pages=chunk_pages,
                        scale=scale)
    handle = cluster.submit(Application.serve(
        arch, shape=serve_shape(backend, max_batch, pool_pages),
        reduced=reduced, name=name, serve=opts))
    if handle.state != "running":
        raise RuntimeError(
            f"{handle.app.name} at {handle.app.shape.name}: demand "
            f"{handle.job.demand_bytes / 2**30:.2f} GiB does not fit the "
            f"card ({cluster.mesh.hbm_per_device / 2**30:.2f} GiB)")
    return handle


def synth_requests(n: int, vocab: int, *,
                   prompt_range: Tuple[int, int] = (64, 1024),
                   max_new: int = 32, seed: int = 0,
                   shared_prefix: int = 0) -> List[Request]:
    """``n`` requests with prompt lengths drawn uniformly from
    ``prompt_range`` (inclusive) with numpy from ``seed``, ``max_new`` new
    tokens each.  With ``shared_prefix`` N > 0 every prompt's tokens are
    explicit: the same first N tokens, drawn from ``seed``, then each
    prompt's own; otherwise the runner synthesizes each prompt from its
    request id."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(prompt_range[0], prompt_range[1] + 1))
            for _ in range(n)]
    if not shared_prefix:
        return [Request(f"r{i}", n_tok, max_new)
                for i, n_tok in enumerate(lens)]
    if shared_prefix >= prompt_range[0]:
        raise ValueError(f"shared_prefix {shared_prefix} must be shorter "
                         f"than the shortest prompt {prompt_range[0]}")
    prefix = rng.integers(0, vocab, shared_prefix).tolist()
    return [Request(f"r{i}", n_tok, max_new, prompt_tokens=tuple(
        prefix + rng.integers(0, vocab, n_tok - shared_prefix).tolist()))
        for i, n_tok in enumerate(lens)]


def serve(arch: str = "tinyllama-1.1b", *, backend: str = "paged",
          reduced: bool = False, device: DeviceLike = None,
          requests: int = 8, max_batch: int = 8, pool_pages: int = 128,
          prompt_range: Tuple[int, int] = (64, 1024),
          max_new: int = 32, seed: int = 0, policy: str = "history",
          private_pool: bool = False, alias_kv: bool = True,
          prefix_cache: bool = False, replicas: int = 1,
          shared_prefix: int = 0, autoscale: bool = False,
          max_replicas: Optional[int] = None, trace: Optional[str] = None,
          metrics_dump: bool = False, metrics_port: Optional[int] = None,
          verbose: bool = True, history_dir: Optional[str] = None,
          executor: Optional[TorchExecutor] = None,
          mesh: Union[str, MeshSpec] = "h100",
          dist_backend: str = "nccl") -> Dict[str, Any]:
    """Serve ``requests`` requests (:func:`synth_requests`) on ``backend``
    ("paged", or "dense" with a cache of ``DENSE_CACHE_LEN`` tokens per
    slot), weights random from ``seed``, through ``replicas`` engine
    replicas on the pod's shared pool (or a private one).  The sizing
    history lives in ``history_dir`` (loaded, and saved at the end) or,
    when None, in memory for this call only.  ``executor`` binds the
    application (default: a ``TorchExecutor`` on ``device`` from
    ``seed``; one whose ``init_params`` returns weights already on the
    card serves them again, and its device wins).  ``autoscale``,
    ``max_replicas``, ``trace``, ``metrics_dump`` and ``metrics_port``
    are the flags of the module docstring.  Returns the engine stats,
    the serving stats view's cumulative dict, the pool, the runner, the
    completed requests, the device and the plan, and with ``autoscale``
    what the control plane did (:func:`_two_bursts`).

    ``mesh`` (a name in ``MESHES`` or a ``MeshSpec``) of several devices
    serves on every rank of a ``torch.distributed`` world of that size
    (joined here over ``dist_backend`` from the environment when this
    process has not joined one); the runner then holds this rank's
    blocks, and only rank 0 prints."""
    mesh = MESHES[mesh] if isinstance(mesh, str) else mesh
    if mesh.num_devices > 1:
        init_world(dist_backend)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    verbose = verbose and rank0
    tracer = obs.enable() if trace else None
    if metrics_dump or metrics_port is not None:
        obs.enable_metrics()
    metrics_srv = None
    if metrics_port is not None:
        metrics_srv = obs.serve_metrics(port=metrics_port)
        if verbose:
            print(f"[metrics] http://127.0.0.1:{metrics_srv.port}/metrics")
    executor = executor or TorchExecutor(device=device, seed=seed)
    dev = executor.device
    history = HistoryStore(history_dir)
    cluster = Cluster(pods=1, mesh=mesh, history=history,
                      executor=executor)
    scale = (ScalePolicy(min_replicas=1, max_replicas=max_replicas)
             if max_replicas is not None else None)
    handle = submit_app(cluster, arch, backend=backend, reduced=reduced,
                        max_batch=max_batch, pool_pages=pool_pages,
                        policy=policy, private_pool=private_pool,
                        alias_kv=alias_kv, prefix_cache=prefix_cache,
                        replicas=replicas, scale=scale)
    if verbose:
        print(f"[placed] {handle.app.name} {handle.app.shape.name} "
              f"pod={handle.pod} demand="
              f"{handle.job.demand_bytes / 2**30:.2f} GiB plan est="
              f"{handle.plan.est_bytes_per_device / 2**30:.2f} GiB on {dev}")
    reqs = synth_requests(requests, handle.app.config.vocab_size,
                          prompt_range=prompt_range, max_new=max_new,
                          seed=seed, shared_prefix=shared_prefix)
    auto = None
    if autoscale:
        auto = _two_bursts(cluster, handle, reqs, verbose)
    else:
        for r in reqs:
            handle.submit_request(r)
        handle.run()
    stats, pool, runner = handle.engine.stats, handle.engine.pool, \
        handle.runner
    view = handle.stats_view.cumulative()
    if verbose and (replicas > 1 or max_replicas is not None):
        rstats = view.get("router", {})
        print(f"[router] replicas={handle.num_replicas} "
              f"dispatched={rstats.get('dispatched', 0)} "
              f"added={rstats.get('replicas_added', 0)} "
              f"removed={rstats.get('replicas_removed', 0)}")
    if verbose:
        print(f"[done] completed={view['completed']} "
              f"tokens={view['tokens_generated']} "
              f"decode_steps={view['decode_steps']} "
              f"preempted={view['preempted']} "
              f"mean_ttft={view['mean_ttft_s'] * 1e3:.2f}ms "
              f"mean_decode_step={view['mean_decode_step_s'] * 1e3:.2f}ms")
        print(f"[pool] pages={pool.num_pages} util={pool.utilization:.2f} "
              f"scaleups={pool.stats['scaleups']} "
              f"denials={pool.stats['denials']}")
        if "prefix_hit_rate" in view:
            print(f"[prefix] hit_rate={view['prefix_hit_rate']:.3f} "
                  f"cow_copies={view['cow_copies']} "
                  f"shared_pages={view['shared_pages']} "
                  f"prefill_pages_computed="
                  f"{view['prefill_pages_computed']}")
        sz = pool.sizing()
        print(f"[sizing/{policy}] init={sz.init:.0f} step={sz.step:.0f}")
    n_events = None
    if tracer is not None:
        meta = {"arch": arch, "backend": backend, "requests": requests}
        if trace.endswith(".jsonl"):
            n_events = obs.write_jsonl(tracer, trace)
        else:
            n_events = obs.write_chrome_trace(tracer, trace,
                                              extra_meta=meta)
        if verbose:
            print(f"[trace] {n_events} events -> {trace} "
                  f"(dropped={tracer.dropped}; summarize: "
                  f"python -m repro_torch.obs {trace})")
        obs.disable()
    if metrics_dump and verbose:
        print("[metrics]")
        print(obs.current_metrics().render(), end="")
    if metrics_srv is not None:
        metrics_srv.stop()
    if metrics_dump or metrics_port is not None:
        obs.disable_metrics()
    plan = handle.plan
    handle.release()
    if rank0:
        history.save()
    return {"stats": stats, "view": view, "pool": pool, "runner": runner,
            "requests": reqs, "device": cluster.executor.device, "plan": plan,
            "autoscale": auto, "trace_events": n_events}


def device_bytes(device) -> Optional[int]:
    """The bytes the live tensors on a CUDA ``device`` asked its allocator
    for (after a synchronize); None for the CPU."""
    import torch
    if device is None or device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_stats(device)["requested_bytes.all.current"]


def _two_bursts(cluster: Cluster, handle, reqs: List[Request],
                verbose: bool) -> Dict[str, Any]:
    """The ``--autoscale`` traffic: the first half of ``reqs``, 6 idle
    ticks of an injected clock (now = 0..5 s) with ``idle_park_s=3.0``,
    then the second half, which unparks the app transparently.  Returns
    the park receipt, the app's device footprint while parked, and on
    CUDA the device's bytes in use (:func:`device_bytes`) just before
    the idle ticks and while parked."""
    dev = cluster.executor.device
    ctl = cluster.enable_autoscale(idle_park_s=3.0, confirm_ticks=1)
    half = max(len(reqs) // 2, 1)
    for r in reqs[:half]:
        handle.submit_request(r)
    handle.run()
    before = device_bytes(dev)
    for t in range(6):              # idle ticks: the parker fires
        cluster.tick(now=float(t))
    parks = [a for a in ctl.log if a["action"] == "park"]
    out = {"park": parks[-1] if parks else None,
           "parked": handle.parked, "before_park_bytes": before,
           "parked_bytes": device_bytes(dev),
           "parked_footprint": cluster.executor.footprint(handle),
           "pod_free_parked": cluster.capacity()[handle.pod]["free_bytes"]}
    if verbose:
        if parks:
            print(f"[autoscale] parked after idle: "
                  f"freed_pages={parks[-1]['freed_pages']} "
                  f"freed_bytes={parks[-1]['freed_bytes']}")
        print(f"[autoscale] parked={handle.parked} "
              f"pod_free={out['pod_free_parked']}")
    for r in reqs[half:]:           # burst 2: transparent unpark
        handle.submit_request(r)
    if verbose:
        print(f"[autoscale] unparked on submit: parked={handle.parked}")
    handle.run()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--backend", default=None, choices=["paged", "dense"],
                    help="paged: RoPE attention stacks over a page pool; "
                         "dense: a per-slot dense cache, which also serves "
                         "the Mamba-2, RWKV-6 and zamba2 stacks (default: "
                         "dense on a mesh of several cards, else paged)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced same-family config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=128)
    ap.add_argument("--prompt-min", type=int, default=64)
    ap.add_argument("--prompt-max", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--policy", default="history",
                    choices=["history", "fixed", "peak"])
    ap.add_argument("--history-dir", default=None,
                    help="sizing-history directory (loaded and saved); "
                         "default: in memory for this run")
    ap.add_argument("--private-pool", action="store_true",
                    help="a page pool of the app's own instead of a view "
                         "of the pod's shared pool")
    ap.add_argument("--no-alias-kv", action="store_true",
                    help="paged backend on the pod pool: page tensors of "
                         "the app's own instead of aliasing the pod's "
                         "same-shape ones")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged backend: refcounted copy-on-write prefix "
                         "cache; repeated prompt prefixes reuse cached KV "
                         "pages and prefill computes only the suffix")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the pod's request router "
                         "(they share the pod pool, the page tensors and "
                         "the weights)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every synthetic prompt the same first N "
                         "tokens (a common system prompt)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="let the autoscale control plane move the "
                         "replica count up to this bound "
                         "(target-tracking on windowed queue depth)")
    ap.add_argument("--autoscale", action="store_true",
                    help="drive the autoscale control plane: two bursts "
                         "with an idle gap; the app is parked between "
                         "them and transparently unparked")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record the request-lifecycle trace and write "
                         "it here: .jsonl -> one event per line, anything "
                         "else -> Chrome/Perfetto trace JSON (summarize "
                         "with `python -m repro_torch.obs PATH`)")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="record latency histograms and print the "
                         "Prometheus text exposition at the end")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="stream Prometheus metrics on this port for the "
                         "run's duration (0 = ephemeral; implies metrics "
                         "recording)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="h100", choices=sorted(MESHES),
                    help="one card (h100), or four as a (2, 2) mesh "
                         "(h100x4, under torchrun --nproc-per-node 4; "
                         "--backend dense)")
    ap.add_argument("--dist-backend", default="nccl",
                    help="torch.distributed backend of a multi-card mesh "
                         "(gloo lets ranks share a card)")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "dense" if MESHES[args.mesh].num_devices > 1 \
            else "paged"
    if args.prefix_cache and args.backend != "paged":
        ap.error("--prefix-cache needs --backend paged: the dense cache "
                 "has no page identity to share across requests")
    serve(args.arch, backend=args.backend, reduced=args.reduced,
          device=args.device, requests=args.requests,
          max_batch=args.max_batch, pool_pages=args.pool_pages,
          prompt_range=(args.prompt_min, args.prompt_max),
          max_new=args.max_new, seed=args.seed, policy=args.policy,
          private_pool=args.private_pool, alias_kv=not args.no_alias_kv,
          prefix_cache=args.prefix_cache, replicas=args.replicas,
          shared_prefix=args.shared_prefix, autoscale=args.autoscale,
          max_replicas=args.max_replicas, trace=args.trace,
          metrics_dump=args.metrics_dump, metrics_port=args.metrics_port,
          history_dir=args.history_dir, mesh=args.mesh,
          dist_backend=args.dist_backend)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
