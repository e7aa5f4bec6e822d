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

``--shared-prefix N`` (this port's own; the reference sets prompt overlap
with explicit ``prompt_tokens``) gives every synthetic prompt the same
first N tokens, as a service whose requests all begin with one system
prompt sends them.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.configs import ShapeConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import H100
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
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
               name: Optional[str] = None):
    """Submit one serving application of ``arch`` to ``cluster`` at the
    traffic's decode shape (:func:`serve_shape`); returns its handle,
    which must be running."""
    opts = ServeOptions(backend=backend, max_batch=max_batch,
                        cache_len=DENSE_CACHE_LEN, pool_pages=pool_pages,
                        policy=policy, private_pool=private_pool,
                        alias_kv=alias_kv, prefix_cache=prefix_cache,
                        replicas=replicas, chunk_pages=chunk_pages)
    handle = cluster.submit(Application.serve(
        arch, shape=serve_shape(backend, max_batch, pool_pages),
        reduced=reduced, name=name, serve=opts))
    if handle.state != "running":
        raise RuntimeError(
            f"{handle.app.name} at {handle.app.shape.name}: demand "
            f"{handle.job.demand_bytes / 2**30:.2f} GiB does not fit the "
            f"card ({H100.hbm_per_device / 2**30:.2f} GiB)")
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
          shared_prefix: int = 0,
          verbose: bool = True, history_dir: Optional[str] = None,
          executor: Optional[TorchExecutor] = None) -> Dict[str, Any]:
    """Serve ``requests`` requests (:func:`synth_requests`) on ``backend``
    ("paged", or "dense" with a cache of ``DENSE_CACHE_LEN`` tokens per
    slot), weights random from ``seed``, through ``replicas`` engine
    replicas on the pod's shared pool (or a private one).  The sizing
    history lives in ``history_dir`` (loaded, and saved at the end) or,
    when None, in memory for this call only.  ``executor`` binds the
    application (default: a ``TorchExecutor`` on ``device`` from
    ``seed``; one whose ``init_params`` returns weights already on the
    card serves them again, and its device wins).  Returns the engine
    stats, the serving stats view's cumulative dict, the pool, the
    runner, the completed requests, the device and the plan."""
    executor = executor or TorchExecutor(device=device, seed=seed)
    dev = executor.device
    history = HistoryStore(history_dir)
    cluster = Cluster(pods=1, mesh=H100, history=history,
                      executor=executor)
    handle = submit_app(cluster, arch, backend=backend, reduced=reduced,
                        max_batch=max_batch, pool_pages=pool_pages,
                        policy=policy, private_pool=private_pool,
                        alias_kv=alias_kv, prefix_cache=prefix_cache,
                        replicas=replicas)
    if verbose:
        print(f"[placed] {handle.app.name} {handle.app.shape.name} "
              f"pod={handle.pod} demand="
              f"{handle.job.demand_bytes / 2**30:.2f} GiB plan est="
              f"{handle.plan.est_bytes_per_device / 2**30:.2f} GiB on {dev}")
    reqs = synth_requests(requests, handle.app.config.vocab_size,
                          prompt_range=prompt_range, max_new=max_new,
                          seed=seed, shared_prefix=shared_prefix)
    for r in reqs:
        handle.submit_request(r)
    handle.run()
    stats, pool, runner = handle.engine.stats, handle.engine.pool, \
        handle.runner
    view = handle.stats_view.cumulative()
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
    plan = handle.plan
    handle.release()
    history.save()
    return {"stats": stats, "view": view, "pool": pool, "runner": runner,
            "requests": reqs, "device": dev, "plan": plan}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--backend", default="paged", choices=["paged", "dense"],
                    help="paged: RoPE attention stacks over a page pool; "
                         "dense: a per-slot dense cache, which also serves "
                         "the Mamba-2, RWKV-6 and zamba2 stacks")
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
          shared_prefix=args.shared_prefix, history_dir=args.history_dir)


if __name__ == "__main__":
    main()
