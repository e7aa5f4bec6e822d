"""Serving steps: prefill and decode over the dense cache, shaped by the
materialization plan.  The port's copy of ``repro/serving/serve_step.py``.

Plain torch callables over the port's :class:`Model`: the serving
runners (``serving/model_runner.py``) drive the same entry points with
the engine's slots and pages; these are the step functions of one
batch on its own.  Greedy decoding is ``argmax`` of the last logits.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.materializer import Plan
from repro_torch.models.model import Model
from repro_torch.models.transformer import ImplConfig


def impl_from_plan(plan: Plan) -> ImplConfig:
    """The serving execution strategy of ``plan``: its attention
    implementation, no rematerialization (nothing is differentiated).
    The reference's block scan/unroll knobs have no counterpart: the
    port's blocks are always a Python loop."""
    return ImplConfig(attn_impl=plan.attn_impl, remat="none")


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    """prefill(params, tokens (B, S)) -> (last-token logits (B, 1, V),
    a dense cache of ``cache_len`` positions)."""
    def prefill(params, tokens):
        return model.prefill(params, tokens, cache_len)
    return prefill


def make_decode_step(model: Model) -> Callable:
    """decode(params, tokens (B, 1), cache, pos) -> (next (B, 1) int32,
    logits, cache), the cache updated in place."""
    def decode(params, tokens, cache, pos):
        logits, cache = model.decode_step(params, tokens, cache, pos)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return decode
