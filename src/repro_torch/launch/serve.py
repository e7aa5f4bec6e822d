"""Serve an architecture on one of the port's backends.

Counterpart of ``repro/launch/serve.py`` for one replica with a private
page pool: it builds the pool, the runner (``PagedRunner`` or
``DenseRunner``) and the :class:`ServingEngine` the way the reference's
executor does for that case, submits synthetic requests and runs them to
completion.  The paged backend serves RoPE attention stacks; the dense
backend also serves the Mamba-2, RWKV-6 and zamba2 hybrid stacks.  Runs
on CUDA unless ``device="cpu"`` is asked for; with no CUDA device and no
explicit CPU request it raises.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b
    python -m repro_torch.launch.serve --arch zamba2-2.7b --backend dense
    python -m repro_torch.launch.serve --reduced --device cpu --requests 4
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagePool, Request
from repro_torch.serving.model_runner import build_runner

# the dense backend's cache per slot: a 1024-token prompt and its new
# tokens fit (zamba2-2.7b's context is 4096; rwkv6-7b keeps no KV)
DENSE_CACHE_LEN = 2048


def serve(arch: str = "tinyllama-1.1b", *, backend: str = "paged",
          reduced: bool = False, device: DeviceLike = None,
          requests: int = 8, max_batch: int = 8, pool_pages: int = 128,
          prompt_range: Tuple[int, int] = (64, 1024),
          max_new: int = 32, seed: int = 0, policy: str = "history",
          verbose: bool = True) -> Dict[str, Any]:
    """Serve ``requests`` requests, prompt lengths drawn uniformly from
    ``prompt_range`` (inclusive) with numpy from ``seed``, ``max_new``
    new tokens each, on ``backend`` ("paged", or "dense" with a cache of
    ``DENSE_CACHE_LEN`` tokens per slot).  Returns the engine stats, the
    pool, the runner and the completed requests."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    runner = build_runner(backend, cfg, seed=seed, max_batch=max_batch,
                          pool_pages=pool_pages, cache_len=DENSE_CACHE_LEN,
                          device=dev)
    pool = PagePool(pool_pages, policy=policy)
    engine = ServingEngine(pool, max_batch=max_batch, runner=runner)
    rng = np.random.default_rng(seed)
    reqs = [Request(f"r{i}", int(rng.integers(prompt_range[0],
                                              prompt_range[1] + 1)), max_new)
            for i in range(requests)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run_to_completion()
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
    return {"stats": stats, "pool": pool, "runner": runner,
            "requests": reqs, "device": dev}


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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serve(args.arch, backend=args.backend, reduced=args.reduced,
          device=args.device, requests=args.requests,
          max_batch=args.max_batch, pool_pages=args.pool_pages,
          prompt_range=(args.prompt_min, args.prompt_max),
          max_new=args.max_new, seed=args.seed, policy=args.policy)


if __name__ == "__main__":
    main()
