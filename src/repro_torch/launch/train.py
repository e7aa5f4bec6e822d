"""Train an architecture with the port: a direct step loop.

Counterpart of ``repro/launch/train.py`` and the training half of the
reference's ``JaxExecutor`` (``_bind_train`` / ``train_step``): seeded
init, the AdamW state, the train step of the plan, synthetic batches
from ``SyntheticLM`` (data seed 0, as the reference), async checkpoints
every ``ckpt_every`` steps and at the end, and resume from the latest
cut.  There is no ``Cluster`` yet: the plan is given, not materialized.
Runs on CUDA unless ``device="cpu"`` is asked for; with no CUDA device
and no explicit CPU request it raises.

    python -m repro_torch.launch.train --arch tinyllama-1.1b
    python -m repro_torch.launch.train --reduced --device cpu --steps 8

A smaller global batch is a ``ShapeConfig`` passed from Python, e.g.
``train("tinyllama-1.1b", shape=ShapeConfig("train_4k_b8", "train", 4096,
8), steps=4)``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Union

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_step,
                                                 restore_checkpoint)
from repro_torch.configs import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import Plan
from repro_torch.data.pipeline import DataConfig, make_loader
from repro_torch.models.model import Model, init_params
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import impl_from_plan, make_train_step

#: the reference's reduced train shape (``runtime/application.py``)
REDUCED_TRAIN = ShapeConfig("reduced_train", "train", 64, 8)


def default_plan(shape: ShapeConfig, reduced: bool) -> Plan:
    """Reduced runs: no remat, one microbatch.  Full size on one card:
    full remat and microbatches of 2 sequences."""
    if reduced:
        return Plan()
    return Plan(remat="full", microbatch=max(1, shape.global_batch // 2))


def train(arch: Union[str, ModelConfig] = "tinyllama-1.1b", *,
          shape: Union[str, ShapeConfig] = "train_4k",
          plan: Optional[Plan] = None,
          opt_cfg: Optional[opt.OptimizerConfig] = None,
          reduced: bool = False, device: DeviceLike = None, steps: int = 100,
          seed: int = 0, ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          resume: bool = False, verbose: bool = True) -> Dict[str, Any]:
    """Train ``steps`` steps (counting from a resumed cut) and return the
    per-step metrics (floats), the final params and optimizer state, and
    the model, plan and shape used.

    ``arch`` is a registered name or a ``ModelConfig``; ``shape`` is a
    name in ``SHAPES`` or a ``ShapeConfig`` (a smaller global batch, say);
    ``reduced`` swaps in the reduced same-family config and shape, as the
    reference's ``Application.train`` does.
    ``seed`` seeds the weights."""
    dev = resolve_device(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    if reduced:
        cfg, sh = reduced_config(cfg), REDUCED_TRAIN
    plan = plan or default_plan(sh, reduced)
    model = Model(cfg, impl_from_plan(plan))
    params = init_params(cfg, seed, dev)
    opt_state = opt.init_opt_state(params)
    step_fn = make_train_step(model, plan, opt_cfg)
    ck = AsyncCheckpointer(ckpt_dir, keep=3) if ckpt_dir else None
    cursor = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        restored, extra, _ = restore_checkpoint(
            ckpt_dir, None, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        cursor = int(extra.get("cursor", 0))
        if verbose:
            print(f"[resume] from step {cursor}")
    if verbose:
        print(f"[plan] {cfg.name} {sh.name} (seq {sh.seq_len} x batch "
              f"{sh.global_batch}) {plan} on {dev}")
    loader = make_loader(DataConfig(cfg.vocab_size, sh.seq_len,
                                    sh.global_batch), start_step=cursor)
    metrics = []
    try:
        while cursor < steps:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(loader).items()}
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            m = {k: float(v) for k, v in m.items()}   # waits for the step
            m["wall_s"] = time.perf_counter() - t0
            metrics.append(m)
            cursor += 1
            if verbose:
                print(f"step {cursor - 1}: loss={m['loss']:.4f} "
                      f"grad_norm={m['grad_norm']:.4f} lr={m['lr']:.3e} "
                      f"({m['wall_s']:.3f}s)")
            if ck and ckpt_every and cursor % ckpt_every == 0:
                ck.save(cursor, {"params": params, "opt": opt_state},
                        extra={"cursor": cursor})
        if ck:
            ck.save(cursor, {"params": params, "opt": opt_state},
                    extra={"cursor": cursor}, block=True)
    finally:
        loader.close()
        if ck:
            ck.wait()
    return {"metrics": metrics, "params": params, "opt_state": opt_state,
            "model": model, "plan": plan, "shape": sh, "device": dev,
            "cursor": cursor}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config and shape")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = train(args.arch, shape=args.shape, reduced=args.reduced,
                device=args.device, steps=args.steps, seed=args.seed,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"[done] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps")


if __name__ == "__main__":
    main()
