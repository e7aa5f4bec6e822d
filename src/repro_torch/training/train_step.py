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
the ``compute`` layout (FSDP's data-split dims gathered once a step,
before the forward); the fp32 gradient sums are averaged over the batch
axes, each rank updates its optimizer slice, and the new bf16 params are
all-gathered back into the ``params`` layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.materializer import Plan
from repro_torch.models.model import Model, param_specs
from repro_torch.models.transformer import ImplConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.planner import PlanLayouts, plan_layouts
from repro_torch.training import optimizer as opt


def impl_from_plan(plan: Plan) -> ImplConfig:
    return ImplConfig(attn_impl=plan.attn_impl, remat=plan.remat,
                      loss_chunk=plan.loss_chunk)


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
        return _sharded_step(model, plan, opt_cfg, mesh, accumulate)

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
    ``params``: the blocks of the ``params`` and ``opt`` layouts, copied,
    so that the whole tree can be freed."""
    flat = opt.leaves(params)
    p_local = opt.tree_unflatten(params, [
        lp.local(p).clone(memory_format=torch.contiguous_format)
        for p, lp in zip(flat, opt.leaves(lay.params))])
    master = opt.tree_unflatten(params, [
        lo.local(p).to(torch.float32, copy=True)
        for p, lo in zip(flat, opt.leaves(lay.opt))])
    return p_local, {"m": opt.tree_map(torch.zeros_like, master),
                     "v": opt.tree_map(torch.zeros_like, master),
                     "master": master,
                     "count": torch.zeros((), dtype=torch.int32)}


def _sharded_step(model: Model, plan: Plan, opt_cfg, mesh,
                  accumulate) -> Callable:
    if plan.grad_compression is not None:
        raise NotImplementedError(
            f"grad_compression={plan.grad_compression!r} on a mesh: the "
            "reference quantizes each whole leaf; the port's ranks hold "
            "slices")
    lay = layouts_of(model, plan, mesh)
    mb = max(plan.microbatch, 1)
    dp_group, dp = mesh.group(plan.batch_axes), mesh.size(plan.batch_axes)
    p_lay, c_lay, o_lay = (opt.leaves(t) for t in (lay.params, lay.compute,
                                                    lay.opt))
    counted = [_counted(lo) for lo in o_lay]

    def step(params, opt_state, batch):
        flat = opt.leaves(params)
        if plan.fsdp:
            flat = [C.gather_to(p, lp, lc)
                    for p, lp, lc in zip(flat, p_lay, c_lay)]
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in flat]
        cparams = opt.tree_unflatten(params, flat)
        del flat
        loss = torch.zeros((), dtype=torch.float32, device=sums[0].device)
        for i in range(mb):
            loss = loss + accumulate(cparams, {k: v[i::mb] for k, v in
                                               batch.items()}, sums)
        del cparams
        # the mean over the batch: over the microbatches, then the ranks
        loss = C.all_reduce(loss / mb, dp_group).div_(dp)
        for g in sums:
            C.all_reduce(g.div_(mb), dp_group).div_(dp)
        grads = opt.tree_unflatten(params, [
            C.narrow_to(g, lc, lo) for g, lc, lo in zip(sums, c_lay, o_lay)])
        new_o, new_opt, om = opt.adamw_update(grads, opt_state, opt_cfg,
                                              counted, mesh.world)
        new_params = opt.tree_unflatten(params, [
            C.gather_to(w, lo, lp)
            for w, lo, lp in zip(opt.leaves(new_o), o_lay, p_lay)])
        metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        return new_params, new_opt, dict(metrics, loss=loss, **om)

    return step
