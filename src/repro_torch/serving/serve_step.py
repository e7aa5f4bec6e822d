"""Serving steps: prefill and decode over the dense cache, shaped by the
materialization plan.  The port's copy of ``repro/serving/serve_step.py``.

Plain torch callables over the port's :class:`Model`: the serving
runners (``serving/model_runner.py``) drive the same entry points with
the engine's slots and pages; these are the step functions of one
batch on its own.  Greedy decoding is ``argmax`` of the last logits.

Under a serving plan of a mesh (``Model(layout=...)``) each rank calls
the steps with its lanes and its blocks of the params and cache, and the
steps return every lane's logits and next tokens on every rank, as the
reference's jitted steps return them replicated (``out_shardings``
None): the rank's lanes' logits are all-gathered over the axes the
cache's lanes are split over.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.materializer import Plan
from repro_torch.models.model import Model, gather_lanes
from repro_torch.models.transformer import ImplConfig


def impl_from_plan(plan: Plan, mesh=None) -> ImplConfig:
    """The serving execution strategy of ``plan``, as
    ``dryrun._model_impl`` sets it for a prefill or decode cell: its
    attention implementation and MoE dispatch, no rematerialization
    (nothing is differentiated), and on ``mesh`` (a ``TorchMesh``) where
    the plan shards the KV cache's sequence (``kv_shard_seq`` or
    ``seq_axes``), the reference's ``decode_shard_ctx`` (mesh, the
    sequence axes, the batch axes; the prefill reads the cache's layout
    instead), and where the plan's ``ep`` is set, the expert-parallel
    ``ep_shard_ctx`` (mesh, ``"model"``, the batch axes).  A plan with
    FSDP (weight-gathered serving) sets nothing more, as in the
    reference, whose partitioner gathers the weights where the jitted
    step needs them: the port's ``Model`` reads the plan's stored and
    compute layouts from its ``layout`` instead.  The reference's block
    scan/unroll knobs have no counterpart: the port's blocks are always a
    Python loop."""
    shard_ctx = ep_ctx = None
    if mesh is not None and (plan.kv_shard_seq or plan.seq_axes):
        shard_ctx = (mesh, tuple(plan.seq_axes or ("model",)),
                     tuple(plan.batch_axes))
    if mesh is not None and plan.ep:
        ep_ctx = (mesh, "model", tuple(plan.batch_axes))
    return ImplConfig(attn_impl=plan.attn_impl, remat="none",
                      decode_shard_ctx=shard_ctx, ep_shard_ctx=ep_ctx,
                      moe_dispatch=plan.moe_dispatch)


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    """prefill(params, tokens (B, S)[, img_feats (B, N, 1024)][,
    enc_feats=(B, T, d)]) -> (last-token logits (B, 1, V), a dense cache
    of ``cache_len`` positions).  A vision-language model's ``img_feats``
    (the reference's ``batch["img_feats"]``) go ahead of the tokens; an
    encoder-decoder's ``enc_feats`` (``batch["enc_feats"]``) are its
    encoder's input frames."""
    def prefill(params, tokens, img_feats=None, enc_feats=None):
        logits, cache = model.prefill(params, tokens, cache_len,
                                      img_feats=img_feats,
                                      enc_feats=enc_feats)
        return gather_lanes(logits, model.lanes), cache
    return prefill


def make_decode_step(model: Model) -> Callable:
    """decode(params, tokens (B, 1), cache, pos) -> (next (B, 1) int32,
    logits, cache), the cache updated in place."""
    def decode(params, tokens, cache, pos):
        logits, cache = model.decode_step(params, tokens, cache, pos)
        logits = gather_lanes(logits, model.lanes)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return decode
