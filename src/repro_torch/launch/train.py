"""Train an architecture with the port, through the resource-centric
runtime.

Counterpart of ``repro/launch/train.py``: it describes the training
application and submits it to a one-pod ``Cluster`` on the card's mesh
(``H100``) with a :class:`TorchExecutor`; the cluster sizes it from the
history store (§9.3), places it at the footprint of the plan it will
run (two-level scheduler), materializes that plan (the locality ladder
with the given ``overrides``), and the executor runs the step loop:
seeded init, the AdamW state, the train step of the plan (cached by
plan layout), synthetic batches from ``SyntheticLM`` (data seed 0, as
the reference), async checkpoints every ``ckpt_every`` steps and at the
end, and resume from the latest cut.  Runs on CUDA unless
``device="cpu"`` is asked for; with no CUDA device and no explicit CPU
request it raises.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 2
    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 8
    python -m repro_torch.launch.train --reduced --device cpu --steps 8

A full-size run given no overrides takes ``ONE_CARD``'s plan: full
remat, microbatches of 2 sequences.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import H100, materialize
from repro_torch.runtime import Application, Cluster, TorchExecutor
from repro_torch.training import optimizer as opt


def one_card_overrides(shape: ShapeConfig) -> Dict[str, Any]:
    """The plan of a full-size run given no overrides: full remat and
    microbatches of 2 sequences, which holds tinyllama-1.1b's train_4k
    in under 26.3 GiB on an H100 at batches of 8 and 256.  The ladder's own
    choice at batch 8, no remat in one microbatch (estimated at 66.8
    GiB), runs out of the card's 80 GB (``PERF.md``)."""
    return {"remat": "full", "microbatch": max(1, shape.global_batch // 2)}


def training_app(arch: Union[str, ModelConfig], shape: ShapeConfig, *,
                 reduced: bool = False, overrides: Optional[Dict] = None,
                 history: Optional[HistoryStore] = None
                 ) -> Tuple[Application, Optional[Dict]]:
    """The training application ``train`` submits and the plan overrides
    it submits it with (``one_card_overrides`` for a full-size run given
    none).  The application's demand is the estimate of that plan, not
    the profile's estimate for the whole batch without remat."""
    if overrides is None and not reduced:
        overrides = one_card_overrides(shape)
    app = Application.train(arch, shape=shape, reduced=reduced)
    app.demand_bytes = materialize(app.config, app.shape, H100,
                                   history=history, overrides=overrides
                                   ).est_bytes_per_device
    return app, overrides


def train(arch: Union[str, ModelConfig] = "tinyllama-1.1b", *,
          shape: Union[str, ShapeConfig] = "train_4k",
          overrides: Optional[Dict] = None,
          opt_cfg: Optional[opt.OptimizerConfig] = None,
          reduced: bool = False, device: DeviceLike = None, steps: int = 100,
          seed: int = 0, ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          resume: bool = False, verbose: bool = True,
          history_dir: Optional[str] = None) -> Dict[str, Any]:
    """Train ``steps`` steps (counting from a resumed cut) and return the
    per-step metrics (floats), the final params and optimizer state, the
    model, plan and shape used, and the job's final grant and the bytes
    it held at its peak.

    ``arch`` is a registered name or a ``ModelConfig``; ``shape`` is a
    name in ``SHAPES`` or a ``ShapeConfig`` (a smaller global batch, say);
    ``reduced`` swaps in the reduced same-family config and shape, as the
    reference's ``Application.train`` does.  ``overrides`` (plan fields)
    replace the ladder's choices; a full-size run given none takes
    ``one_card_overrides``, a reduced one the ladder's plan.  The job is
    placed at the plan's estimate (or from the history of earlier runs)
    and grows its grant to what it holds on the card.  ``seed`` seeds
    the weights.  Checkpoints go to
    ``ckpt_dir``/<app name>; the sizing history lives in ``history_dir``
    (loaded, and saved at the end) or in memory when None."""
    dev = resolve_device(device)
    history = HistoryStore(history_dir)
    app, overrides = training_app(
        arch, SHAPES[shape] if isinstance(shape, str) else shape,
        reduced=reduced, overrides=overrides, history=history)
    cluster = Cluster(pods=1, mesh=H100, history=history,
                      executor=TorchExecutor(device=dev, seed=seed,
                                             ckpt_dir=ckpt_dir,
                                             ckpt_every=ckpt_every,
                                             resume=resume, opt_cfg=opt_cfg))
    handle = cluster.submit(app, overrides=overrides)
    if handle.state != "running":
        raise RuntimeError(
            f"{handle.app.name} at {handle.app.shape.name} (batch "
            f"{handle.app.shape.global_batch}): demand "
            f"{handle.job.demand_bytes / 2**30:.2f} GiB does not fit the "
            f"card ({H100.hbm_per_device / 2**30:.2f} GiB); cut the batch "
            "or add microbatches")
    cfg, sh, plan = handle.app.config, handle.app.shape, handle.plan
    if verbose:
        print(f"[plan] {cfg.name} {sh.name} (seq {sh.seq_len} x batch "
              f"{sh.global_batch}) remat={plan.remat} "
              f"microbatch={plan.microbatch} est="
              f"{plan.est_bytes_per_device / 2**30:.2f} GiB/device "
              f"notes={plan.notes} on {dev}")
        print(f"[placed] pod={handle.pod} "
              f"demand={handle.job.demand_bytes / 2**30:.2f} GiB")
        if handle.cursor:
            print(f"[resume] from step {handle.cursor}")
    metrics = []
    while handle.cursor < steps:
        m = handle.step()
        metrics.append({k: v for k, v in m.items() if k != "straggled"})
        if verbose:
            print(f"step {handle.cursor - 1}: loss={m['loss']:.4f} "
                  f"grad_norm={m['grad_norm']:.4f} lr={m['lr']:.3e} "
                  f"({m['wall_s']:.3f}s)"
                  + (" [straggled]" if m["straggled"] else ""))
    held = cluster.executor.footprint(handle)
    if verbose:
        print(f"[footprint] held {held / 2**30:.2f} GiB at peak, grant "
              f"{handle.job.demand_bytes / 2**30:.2f} GiB")
    handle.checkpoint()
    st = handle.exec_state
    out = {"metrics": metrics, "params": st["params"],
           "opt_state": st["opt_state"], "model": st["model"],
           "plan": plan, "shape": sh, "device": dev,
           "cursor": handle.cursor, "grant": handle.job.demand_bytes,
           "held": held}
    handle.release()
    history.save()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config and shape")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--history-dir", default=None,
                    help="sizing-history directory (loaded and saved); "
                         "default: in memory for this run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shape = SHAPES[args.shape]
    if args.batch is not None:
        shape = dataclasses.replace(shape, name=f"{shape.name}_b{args.batch}",
                                    global_batch=args.batch)
    out = train(args.arch, shape=shape, reduced=args.reduced,
                device=args.device, steps=args.steps, seed=args.seed,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, history_dir=args.history_dir)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"[done] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps")


if __name__ == "__main__":
    main()
