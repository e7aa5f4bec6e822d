"""Serve an architecture on one of the port's backends, through the
resource-centric runtime.

Counterpart of ``repro/launch/serve.py``: it describes the serving
application and submits it to a one-pod ``Cluster`` on the card's mesh
(``H100``) with a :class:`TorchExecutor`; the cluster sizes it from the
history store (§9.3), places it (two-level scheduler), materializes it
(locality ladder) and binds one engine replica on a private page pool.
The requests go through the handle (``submit_request`` -> the pod's
router -> the engine) and ``handle.run()`` drains them.  The paged
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
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple

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


def serve(arch: str = "tinyllama-1.1b", *, backend: str = "paged",
          reduced: bool = False, device: DeviceLike = None,
          requests: int = 8, max_batch: int = 8, pool_pages: int = 128,
          prompt_range: Tuple[int, int] = (64, 1024),
          max_new: int = 32, seed: int = 0, policy: str = "history",
          verbose: bool = True, history_dir: Optional[str] = None,
          executor: Optional[TorchExecutor] = None) -> Dict[str, Any]:
    """Serve ``requests`` requests, prompt lengths drawn uniformly from
    ``prompt_range`` (inclusive) with numpy from ``seed``, ``max_new``
    new tokens each, on ``backend`` ("paged", or "dense" with a cache of
    ``DENSE_CACHE_LEN`` tokens per slot), weights random from ``seed``.
    The sizing history lives in ``history_dir`` (loaded, and saved at the
    end) or, when None, in memory for this call only.  ``executor``
    binds the application (default: a ``TorchExecutor`` on ``device``
    from ``seed``; one whose ``init_params`` returns weights already on
    the card serves them again, and its device wins).  Returns the
    engine stats, the pool, the runner, the completed requests, the
    device and the plan."""
    executor = executor or TorchExecutor(device=device, seed=seed)
    dev = executor.device
    history = HistoryStore(history_dir)
    opts = ServeOptions(backend=backend, max_batch=max_batch,
                        cache_len=DENSE_CACHE_LEN, pool_pages=pool_pages,
                        policy=policy, private_pool=True)
    cluster = Cluster(pods=1, mesh=H100, history=history,
                      executor=executor)
    handle = cluster.submit(Application.serve(
        arch, shape=serve_shape(backend, max_batch, pool_pages),
        reduced=reduced, serve=opts))
    if handle.state != "running":
        raise RuntimeError(
            f"{handle.app.name} at {handle.app.shape.name}: demand "
            f"{handle.job.demand_bytes / 2**30:.2f} GiB does not fit the "
            f"card ({H100.hbm_per_device / 2**30:.2f} GiB)")
    if verbose:
        print(f"[placed] {handle.app.name} {handle.app.shape.name} "
              f"pod={handle.pod} demand="
              f"{handle.job.demand_bytes / 2**30:.2f} GiB plan est="
              f"{handle.plan.est_bytes_per_device / 2**30:.2f} GiB on {dev}")
    rng = np.random.default_rng(seed)
    reqs = [Request(f"r{i}", int(rng.integers(prompt_range[0],
                                              prompt_range[1] + 1)), max_new)
            for i in range(requests)]
    for r in reqs:
        handle.submit_request(r)
    handle.run()
    stats, pool, runner = handle.engine.stats, handle.engine.pool, \
        handle.runner
    if verbose:
        print(f"[done] completed={stats.completed} "
              f"tokens={stats.tokens_generated} "
              f"decode_steps={stats.decode_steps} "
              f"preempted={stats.preempted} "
              f"mean_ttft={stats.mean_ttft_s * 1e3:.2f}ms "
              f"mean_decode_step={stats.mean_decode_step_s * 1e3:.2f}ms")
        print(f"[pool] pages={pool.num_pages} util={pool.utilization:.2f} "
              f"scaleups={pool.stats['scaleups']} "
              f"denials={pool.stats['denials']}")
        sz = pool.sizing()
        print(f"[sizing/{policy}] init={sz.init:.0f} step={sz.step:.0f}")
    plan = handle.plan
    handle.release()
    history.save()
    return {"stats": stats, "pool": pool, "runner": runner,
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serve(args.arch, backend=args.backend, reduced=args.reduced,
          device=args.device, requests=args.requests,
          max_batch=args.max_batch, pool_pages=args.pool_pages,
          prompt_range=(args.prompt_min, args.prompt_max),
          max_new=args.max_new, seed=args.seed, policy=args.policy,
          history_dir=args.history_dir)


if __name__ == "__main__":
    main()
