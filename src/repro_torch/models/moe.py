"""Mixture-of-Experts FFN with capacity dispatch: the counterpart of
``repro/models/moe.py`` on its single-shard path (``shard_ctx=None``).

Routing, top-k, the capacity dispatch and the combine follow the
reference step for step, since which tokens a full expert drops at
prefill decides the tokens served:

* the router is padded to a multiple of 16 experts (60 -> 64 for
  qwen2-moe, 8 -> 16 in the reduced configs), the pad logits set to
  -1e30, so pads are never chosen;
* each padded expert takes ``_capacity`` tokens, computed over the padded
  count; a token's slot in its expert is its rank among the token-major
  (token, k) pairs routed there (a stable sort), and pairs past the
  capacity write a trash row that is then discarded;
* the (E, C, D) buffer goes through three bf16 batched products -- plain
  large products, which the reference also leaves to XLA outside any
  Pallas kernel;
* the combine adds the k slot outputs one bf16 add at a time, in slot
  order: that is bit-equal to the reference's bf16 ``segment_sum``,
  which a sum over the slots or ``index_add_`` (both accumulating in fp32
  and rounding once) is not.

The expert-parallel dispatches (the reference's psum and a2a shard_map
paths) need a mesh of several cards and wait for the multi-card slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiles import padded_num_experts
from repro_torch.models.layers import Spec, gated_mlp, gated_mlp_specs

Params = Dict[str, Any]

NEG = -1e30


def moe_specs(cfg: ModelConfig) -> Params:
    m = cfg.moe
    d = cfg.d_model
    e = padded_num_experts(m.num_experts)
    p: Params = {"router": Spec((d, e)),
                 "we_gate": Spec((e, d, m.d_expert)),
                 "we_up": Spec((e, d, m.d_expert)),
                 "we_down": Spec((e, m.d_expert, d))}
    if m.num_shared_experts > 0:
        p["shared"] = gated_mlp_specs(d, m.d_shared_expert)
        p["shared_gate"] = Spec((d, 1))
    return p


def _capacity(tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(tokens * top_k * capacity_factor / num_experts)
    return max(8, (c + 7) // 8 * 8)


def router_probs(p_router: torch.Tensor, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Router probabilities of (T, D) tokens over the padded experts, fp32
    (T, E_pad): the logits are the product in x's dtype, then fp32, the
    pads' set to -1e30."""
    logits = torch.matmul(x, p_router).float()
    if p_router.shape[-1] > cfg.moe.num_experts:
        logits[:, cfg.moe.num_experts:] = NEG
    return torch.softmax(logits, dim=-1)


def routed(probs: torch.Tensor, ids: torch.Tensor, cfg: ModelConfig,
           dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights (T, k) in ``dtype`` and the fp32 balance loss of tokens
    routed to the experts ``ids`` (T, k) by the probabilities ``probs``."""
    weights = torch.gather(probs, 1, ids)
    weights = weights / weights.sum(-1, keepdim=True)
    # the share of tokens routed to each expert: a scatter of ones, where
    # ``F.one_hot`` would sync with the card to check the ids
    ce = torch.zeros(probs.shape[-1], device=probs.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=probs.device)) \
        / ids.shape[0]
    aux = (probs.mean(0) * ce).sum() * float(cfg.moe.num_experts)
    return weights.to(dtype), aux


def route(p_router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on (T, D) tokens -> (weights (T, k) in x's dtype, ids (T, k),
    the fp32 balance loss)."""
    probs = router_probs(p_router, x, cfg)
    # the lower expert first among equal probabilities, as ``lax.top_k``
    # orders them (``torch.topk`` does not say): the slot order decides
    # the dispatch ranks and the combine's order of adds
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe.top_k]
    weights, aux = routed(probs, ids, cfg, x.dtype)
    return weights, ids, aux


def dispatch_slots(ids: torch.Tensor, e_total: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buffer row of each token-major (token, k) pair -> (slot (T*k,),
    keep (T*k,) bool): ``id * cap + rank`` where the pair's rank among the
    pairs routed to its expert (a stable sort of the ids) is below ``cap``,
    else the trash row ``e_total * cap``."""
    flat_ids = ids.reshape(-1)
    n = flat_ids.numel()
    order = torch.sort(flat_ids, stable=True).indices
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(e_total, device=ids.device, dtype=ids.dtype))
    pos_sorted = torch.arange(n, device=ids.device) - seg_start[sorted_ids]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos,
                       torch.full_like(pos, e_total * cap))
    return slot, keep


def combine(gathered: torch.Tensor, k: int) -> torch.Tensor:
    """(T*k, D) weighted slot outputs, token-major -> (T, D): one add at a
    time in the slot order, each rounded to the rows' dtype (the
    reference's ``segment_sum`` on bf16 rows, bit for bit)."""
    g = gathered.unflatten(0, (-1, k))
    y = torch.zeros_like(g[:, 0])
    for j in range(k):
        y = y + g[:, j]
    return y


def _local_expert_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig,
                      e_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts on (T, D) tokens -> (y (T, D), aux).  ``p["we_*"]``
    hold all ``e_total`` (padded) experts."""
    m = cfg.moe
    t, d = x.shape
    k = m.top_k
    cap = _capacity(t, e_total, k, m.capacity_factor)
    weights, ids, aux = route(p["router"], x, cfg)
    slot, _ = dispatch_slots(ids, e_total, cap)

    buf = torch.zeros((e_total * cap + 1, d), dtype=x.dtype, device=x.device)
    # each token's row once per (token, k) pair, token-major (the
    # reference's ``x[token_of]``): as an expand, whose gradient is a sum
    # over k in a fixed order, where a gather's is a scatter-add
    buf[slot] = x.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
    ebuf = buf[:e_total * cap].view(e_total, cap, d)
    h = F.silu(torch.bmm(ebuf, p["we_gate"])) * torch.bmm(ebuf, p["we_up"])
    out = torch.bmm(h, p["we_down"]).reshape(e_total * cap, d)
    # each pair's output row (zeros for a dropped pair), the reference's
    # ``out[slot]``, as a scatter of every slot's row to the pair that
    # filled it (empty slots, zero rows, to a trash pair): its gradient is
    # a gather, where the gather's is an accumulating scatter in which
    # every dropped pair's trash index serialises on the card
    n = t * k
    pair = torch.full((e_total * cap + 1,), n, device=x.device).index_put_(
        (slot,), torch.arange(n, device=x.device))[:e_total * cap]
    gathered = out.new_zeros(n + 1, d).index_put((pair,), out)[:n]
    return combine(gathered * weights.reshape(-1, 1), k), aux


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
              shard_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux), every token of the B x S routed together
    (the capacity is over all of them).  Shared experts (qwen2) add an
    fp32 sigmoid gate, cast to x's dtype, times their gated MLP."""
    if shard_ctx is not None:
        raise NotImplementedError(
            "moe_block: the expert-parallel dispatch over a mesh comes with "
            "the multi-card slice (ROADMAP item A8); the port runs the "
            "single-shard path")
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    m = cfg.moe
    y, aux = _local_expert_ffn(flat, p, cfg, padded_num_experts(m.num_experts))
    if m.num_shared_experts > 0:
        gate = torch.sigmoid(torch.matmul(flat, p["shared_gate"]).float())
        y = y + gate.to(flat.dtype) * gated_mlp(p["shared"], flat)
    return y.reshape(b, s, d), aux
