"""Train step factory: model + plan -> step(params, opt_state, batch).

A copy of ``repro/training/train_step.py``: microbatch gradient
accumulation in fp32, the model's remat policy, optional int8 gradient
fake-quantization, and the AdamW update.  Where the reference traces one
jitted step, the port runs it eagerly; gradients come from
``torch.autograd.grad`` through the model's kernels' autograd Functions.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.materializer import Plan
from repro_torch.models.model import Model
from repro_torch.models.transformer import ImplConfig
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
                    opt_cfg: Optional[opt.OptimizerConfig] = None
                    ) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"ce", "aux", "loss", "grad_norm", "lr"}.

    ``batch`` leaves have global shapes (B, S); with ``plan.microbatch``
    = mb > 1 microbatch i takes rows i::mb (the reference's static
    split), their fp32 gradients are summed and divided by mb.  The
    optimizer state is updated in place (``adamw_update``)."""
    opt_cfg = opt_cfg or opt.OptimizerConfig()
    mb = max(plan.microbatch, 1)

    def grads_of(params, batch):
        tracked = opt.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        loss, metrics = model.loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, opt.leaves(tracked))
        return loss.detach(), metrics, opt.tree_unflatten(params, grads)

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
                l, _, g = grads_of(params, {k: v[i::mb]
                                            for k, v in batch.items()})
                for acc, gi in zip(opt.leaves(grads), opt.leaves(g)):
                    acc.add_(gi)
                loss = loss + l
            grads = opt.tree_map(lambda g: g.div_(mb), grads)
            loss = loss / mb
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if plan.grad_compression == "int8":
            grads = opt.tree_map(_compress_int8, grads)
        new_params, new_opt, om = opt.adamw_update(grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss, **om)

    return step
