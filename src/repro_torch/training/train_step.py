"""Train step factory: model + plan -> step(params, opt_state, batch).

A copy of ``repro/training/train_step.py``: microbatch gradient
accumulation in fp32, the model's remat policy, optional int8 gradient
fake-quantization, and the AdamW update.  Where the reference traces one
jitted step, the port runs it eagerly; gradients come from
``torch.autograd.grad`` through the model's kernels' autograd Functions.

On a mesh of several ranks (``mesh=``) the step is the one the
reference's partitioner makes of the planner's layouts
(``sharding.planner.plan_layouts``), with the collectives written out
(``sharding.collectives``): each rank holds its block of the params
(``params`` layout) and of the fp32 optimizer state (``opt``: ZeRO/FSDP
slices) and gets its rows of the batch; the forward and backward run on
the ``compute`` layout, through ``collectives.ShardedParams``: an
FSDP-split stacked block is all-gathered inside its remat body (for its
forward, and again for its recompute), the components outside the
blocks once a microbatch, and each block's gradients are summed over the
batch axes straight into this rank's fp32 slices of the optimizer
layout as the backward produces them (a reduce-scatter over ZeRO's and
FSDP's axes, an all-reduce over the rest), so no compute-layout gradient
sum and no whole gathered tree exists.  The sums are divided by the
microbatches and the batch ranks, each rank updates its optimizer slice
(AdamW a stacked leaf one block slice at a time), and the new bf16 params
are written into the stored ones in place (all-gathered from the ZeRO
slices where those are finer), as the reference's ``donate_argnums``
lets its step reuse them: the caller's params are the step's.  Under
expert parallelism an expert leaf's compute block is the rank's own
experts: its gradient is summed over the batch axes only, like every
leaf's (a leaf whose whole several ``model`` ranks apply sums its parts
over ``model`` in the backward, ``collectives.copy_to_tp``), and the
global norm counts each expert block once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.materializer import Plan
from repro_torch.models.model import Model, param_specs
from repro_torch.models.transformer import ImplConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.planner import PlanLayouts, plan_layouts
from repro_torch.training import optimizer as opt


def impl_from_plan(plan: Plan, mesh=None) -> ImplConfig:
    """The plan's execution strategy.  On ``mesh`` (a ``TorchMesh``) of
    several ``model`` ranks, a plan with expert parallelism (``ep``) runs
    the MoE blocks' routed experts over that axis with the plan's
    dispatch (the reference's ``ep_shard_ctx``)."""
    ep_ctx = None
    if plan.ep and mesh is not None and mesh.size(("model",)) > 1:
        ep_ctx = (mesh, "model", tuple(plan.batch_axes))
    return ImplConfig(attn_impl=plan.attn_impl, remat=plan.remat,
                      loss_chunk=plan.loss_chunk, ep_shard_ctx=ep_ctx,
                      moe_dispatch=plan.moe_dispatch)


def _compress_int8(g: torch.Tensor) -> torch.Tensor:
    """int8 quantize-dequantize in ``g``'s dtype (the reference's
    simulated compressed all-reduce payload)."""
    scale = torch.clamp(g.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def make_train_step(model: Model, plan: Plan,
                    opt_cfg: Optional[opt.OptimizerConfig] = None,
                    mesh=None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"ce", "aux", "loss", "grad_norm", "lr"}.

    ``batch`` leaves have global shapes (B, S); with ``plan.microbatch``
    = mb > 1 microbatch i takes rows i::mb (the reference's static
    split), their fp32 gradients are summed and divided by mb: each
    leaf's gradient is added into its fp32 sum as soon as the backward
    has produced it and freed there (``accumulate``), so no whole tree of
    one microbatch's gradients is held (at gemma3-12b's full width with
    12 layers that tree is 6.9 GiB, and holding it ran the card out of
    memory).  The optimizer state is updated in place
    (``adamw_update``).

    With ``mesh`` (a ``launch.mesh.TorchMesh`` of several ranks),
    ``params`` and ``opt_state`` are this rank's blocks
    (:func:`shard_state`), ``batch`` this rank's rows (``data.pipeline.
    rank_rows``) and microbatch i its local rows i::mb; the loss is the
    mean over the batch axes (see the module doc)."""
    opt_cfg = opt_cfg or opt.OptimizerConfig()
    mb = max(plan.microbatch, 1)

    def grads_of(params, batch):
        tracked = opt.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        loss, metrics = model.loss_fn(tracked, batch)
        leaves = opt.leaves(tracked)
        # a leaf the batch does not reach (phi-3-vision's image projection
        # on text alone) takes a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        return loss.detach(), metrics, opt.tree_unflatten(params, grads)

    def accumulate(params, batch, sums):
        """One microbatch's backward, each leaf's gradient added into its
        fp32 sum (``sums``, the leaves' order) when it is ready and then
        dropped; a leaf the batch does not reach adds nothing, as the
        zeros of :func:`grads_of` would.  Returns the loss."""
        tracked = opt.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        leaves = opt.leaves(tracked)

        def into(acc):
            def hook(p):
                acc.add_(p.grad)
                p.grad = None
            return hook

        for p, acc in zip(leaves, sums):
            p.register_post_accumulate_grad_hook(into(acc))
        loss, _ = model.loss_fn(tracked, batch)
        torch.autograd.backward(loss, inputs=leaves)
        return loss.detach()

    if mesh is not None and mesh.spec.num_devices > 1:
        return _sharded_step(model, plan, opt_cfg, mesh)

    def step(params, opt_state, batch):
        if mb == 1:
            loss, metrics, grads = grads_of(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(mb):
                loss = loss + accumulate(params, {k: v[i::mb] for k, v in
                                                  batch.items()},
                                         opt.leaves(grads))
            grads = opt.tree_map(lambda g: g.div_(mb), grads)
            loss = loss / mb
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if plan.grad_compression == "int8":
            grads = opt.tree_map(_compress_int8, grads)
        new_params, new_opt, om = opt.adamw_update(grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss, **om)

    return step


def layouts_of(model: Model, plan: Plan, mesh) -> PlanLayouts:
    return plan_layouts(plan, model.cfg, param_specs(model.cfg), mesh)


def _counted(lay) -> bool:
    """Whether this rank counts its slice of a leaf of layout ``lay`` in
    the global norm: the one with coordinate 0 along every axis the leaf
    is not split over counts it."""
    split = lay.split_axes
    return all(c == 0 for a, c in lay.mesh.coords.items() if a not in split)


def shard_state(params, lay: PlanLayouts):
    """(this rank's params, its optimizer state) from the whole
    ``params``: the blocks of the ``params`` and ``opt`` layouts, copied.
    ``params`` is consumed: each whole leaf leaves its tree once its
    blocks are copied, so the whole tree and this rank's state are never
    on the device together (qwen2-moe-a2.7b's 24 layers are 28.6 GB of
    bf16 weights on each rank)."""
    p_local, master = _shard(params, lay.params, lay.opt)
    return p_local, {"m": opt.tree_map(torch.zeros_like, master),
                     "v": opt.tree_map(torch.zeros_like, master),
                     "master": master,
                     "count": torch.zeros((), dtype=torch.int32)}


def _shard(tree, lp_tree, lo_tree):
    p_local, master = {}, {}
    for k in sorted(tree):
        whole = tree.pop(k)
        if isinstance(whole, dict):
            p_local[k], master[k] = _shard(whole, lp_tree[k], lo_tree[k])
        else:
            p_local[k] = lp_tree[k].local(whole).clone(
                memory_format=torch.contiguous_format)
            master[k] = lo_tree[k].local(whole).to(torch.float32, copy=True)
        del whole
    return p_local, master


def _sharded_step(model: Model, plan: Plan, opt_cfg, mesh) -> Callable:
    if plan.grad_compression is not None:
        raise NotImplementedError(
            f"grad_compression={plan.grad_compression!r} on a mesh: the "
            "reference quantizes each whole leaf; the port's ranks hold "
            "slices")
    lay = layouts_of(model, plan, mesh)
    mb = max(plan.microbatch, 1)
    dp_group, dp = mesh.group(plan.batch_axes), mesh.size(plan.batch_axes)
    p_lay, o_lay = opt.leaves(lay.params), opt.leaves(lay.opt)
    counted = [_counted(lo) for lo in o_lay]
    stacks = opt.stacked(lay.params)

    def step(params, opt_state, batch):
        device = batch["tokens"].device
        shards = C.ShardedParams(lay, plan.batch_axes, device)
        smodel = Model(model.cfg, model.impl, model.tp, shards=shards)
        shards.begin(opt_state["master"])
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(mb):
            mloss, _ = smodel.loss_fn(params, {k: v[i::mb] for k, v in
                                               batch.items()})
            mloss.backward()
            loss = loss + mloss.detach()
        sums = shards.end()
        # the mean over the batch: over the microbatches, then the ranks
        loss = C.all_reduce(loss / mb, dp_group).div_(dp)
        grads = opt.tree_map(lambda g: g.div_(mb).div_(dp), sums)
        _, new_opt, om = opt.adamw_update(grads, opt_state, opt_cfg,
                                          counted, mesh.world,
                                          new_params=False)
        del grads, sums
        flat = opt.leaves(params)
        for i, (p, w, lo, lp, stack) in enumerate(zip(
                flat, opt.leaves(new_opt["master"]), o_lay, p_lay, stacks)):
            flat[i] = _write_params(p, w, lo, lp, stack)
        metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        return (opt.tree_unflatten(params, flat), new_opt,
                dict(metrics, loss=loss, **om))

    return step


def _write_params(p: torch.Tensor, w: torch.Tensor, lo, lp,
                  stack: bool) -> torch.Tensor:
    """The new params ``p`` (this rank's block under ``lp``) from the fp32
    master ``w`` (its block under ``lo``, the same or finer), rounded to
    bf16: written into ``p`` in place when it is bf16 (the reference's
    ``donate_argnums``: no second copy of the params), block slice by
    block slice for a stack, each all-gathered from the ZeRO slices
    where ``lo`` splits further; a new bf16 tensor for params of another
    dtype (fp32 weights), as the one-device step returns."""
    if p.dtype != torch.bfloat16:
        return C.gather_to(w.to(torch.bfloat16), lo, lp)
    if lo == lp:
        return p.copy_(w)
    if not stack:
        return p.copy_(C.gather_to(w.to(torch.bfloat16), lo, lp))
    lo1, lp1 = (dataclasses.replace(x, dims=x.dims[1:]) for x in (lo, lp))
    for pj, wj in zip(p, w):
        pj.copy_(C.gather_to(wj.to(torch.bfloat16), lo1, lp1))
    return p
