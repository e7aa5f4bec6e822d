"""AdamW with fp32 master weights, global-norm clipping and schedules: a
copy of ``repro/training/optimizer.py``.

The state is a plain tree, so the checkpointer writes it in the
reference's format:

    opt_state = {"m": fp32, "v": fp32, "master": fp32, "count": int32}

``count`` is a 0-d int32 tensor kept on the host, so the schedule and
the bias corrections are computed there with no device sync.  Unlike the
reference, whose arrays are immutable, :func:`adamw_update` updates
``m``, ``v``, ``master`` and the gradients in place: at full
tinyllama-1.1b width a second copy of the fp32 state would be another
13 GB.  ``torch.optim.AdamW`` is not used: it applies the decay to the
weights before the Adam step, the reference adds it to the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step) -> float:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr`` at
    ``decay_steps``; computed in fp32 as the reference does."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(_f32(math.pi) * frac))
    return float(torch.where(step < cfg.warmup_steps, warm, cos))


def leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (the reference's
    pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Params, flat) -> Params:
    """The tree of ``like`` with the leaves of ``flat`` (in :func:`leaves`
    order)."""
    return _build(like, iter(flat))


def _build(like: Params, it) -> Params:
    # a plain recursion: a recursive closure would be a reference cycle
    # holding ``flat``'s leaves until the cyclic collector runs (during a
    # backward, every gathered block at once)
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    return next(it)


def tree_map(fn, tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params: Params) -> Dict[str, Any]:
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "count": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree: Params, counted: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """The L2 norm of every leaf.  On a mesh, ``tree`` holds this rank's
    slices: ``counted`` says, leaf by leaf, whether this rank counts its
    slice (one rank of each set of replicas does), the sums of squares
    are added over ``group``, the whole mesh, and a stacked leaf is
    squared one block slice at a time (a whole stacked expert leaf's
    square is 4.12 GiB a rank at qwen2-moe-a2.7b's 24 layers)."""
    if counted is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in leaves(tree)))
    flat = leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for g, c, stack in zip(flat, counted, stacked(tree)):
        if c:
            for gs in (g if stack else (g,)):
                sq = sq + gs.float().square().sum()
    if group is not None:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def stacked(tree: Params, under: bool = False) -> List[bool]:
    """Per leaf of ``tree`` (in :func:`leaves` order), whether it is a
    stack of blocks: a leaf under a ``blocks`` key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in stacked(tree[k], under or k == "blocks")]
    return [under]


def _adam_slice(g, m, v, w, scale, lr, bc1, bc2, cfg) -> None:
    """One slice of a leaf's AdamW update, in place (``g`` too when it is
    fp32); elementwise, so a leaf updated slice by slice is bit-equal to
    one updated whole."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square_() * (1 - b2))
    step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    w.sub_(step.add_(w, alpha=cfg.weight_decay).mul_(lr))


def adamw_update(grads: Params, opt_state: Dict[str, Any],
                 cfg: OptimizerConfig, counted: Optional[List[bool]] = None,
                 group=None, new_params: bool = True
                 ) -> Tuple[Optional[Params], Dict[str, Any], Dict[str, Any]]:
    """Returns (new bf16 params, new opt state, metrics).  Updates the
    state's ``m``, ``v`` and ``master`` in place, and fp32 gradients too
    (see the module doc), a stacked leaf one block slice at a time, so
    the update's fp32 temporaries are one block's.  On a mesh the
    gradients and the state are this rank's slices of the optimizer-state
    layout, and so are the new params; ``counted`` and ``group`` go to
    :func:`global_norm`.  With ``new_params=False`` no bf16 copy is made
    (the caller writes ``master`` into its params itself) and None is
    returned in its place."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads, counted, group)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, count)
    bc1 = float(1 - _f32(cfg.b1) ** count.float())
    bc2 = float(1 - _f32(cfg.b2) ** count.float())
    for g, m, v, w, stack in zip(leaves(grads), leaves(opt_state["m"]),
                                 leaves(opt_state["v"]),
                                 leaves(opt_state["master"]),
                                 stacked(opt_state["master"])):
        parts = zip(g, m, v, w) if stack else ((g, m, v, w),)
        for gs, ms, vs, ws in parts:
            _adam_slice(gs, ms, vs, ws, scale, lr, bc1, bc2, cfg)
    out = None
    if new_params:
        out = tree_map(lambda w: w.to(torch.bfloat16), opt_state["master"])
    new_state = dict(opt_state, count=count)
    return out, new_state, {"grad_norm": gnorm, "lr": lr}
