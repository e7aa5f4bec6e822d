"""Mixture-of-Experts FFN with capacity dispatch: the counterpart of
``repro/models/moe.py``, on one shard and over a mesh.

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

Over a mesh (``shard_ctx``), the reference's two expert-parallel
dispatches, with the collectives its ``shard_map`` implies written out
(``sharding.collectives``); each rank holds its block of ``e_pad / n``
experts along the ``model`` axis of n ranks, and the router's columns
are all-gathered:

* ``psum``: every model rank routes its data shard's tokens, runs its own
  experts' pairs (the others write the trash row) and the partial
  outputs are summed over ``model``;
* ``a2a``: the data shard's tokens are split over ``model``; each rank
  routes its slice, with the capacity over the slice's tokens (so its
  drops differ from the single-shard path's, as in the reference), and
  two all-to-alls carry each expert's rows to the rank that owns it and
  back.

In both the balance loss is the mean over every rank of the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiles import padded_num_experts
from repro_torch.models.layers import Spec, gated_mlp, gated_mlp_specs
from repro_torch.sharding import collectives as C

Params = Dict[str, Any]

NEG = -1e30


def moe_specs(cfg: ModelConfig) -> Params:
    m = cfg.moe
    d = cfg.d_model
    e = padded_num_experts(m.num_experts)
    p: Params = {
        "router": Spec((d, e), ("embed", "experts")),
        "we_gate": Spec((e, d, m.d_expert), ("experts", "embed", "expert_ffn")),
        "we_up": Spec((e, d, m.d_expert), ("experts", "embed", "expert_ffn")),
        "we_down": Spec((e, m.d_expert, d),
                        ("experts", "expert_ffn", "embed"))}
    if m.num_shared_experts > 0:
        p["shared"] = gated_mlp_specs(d, m.d_shared_expert)
        p["shared_gate"] = Spec((d, 1), ("embed", None))
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


def _experts(ebuf: torch.Tensor, p: Params) -> torch.Tensor:
    """The (E, C, D) buffer through each expert's gated MLP: three bf16
    batched products."""
    h = F.silu(torch.bmm(ebuf, p["we_gate"])) * torch.bmm(ebuf, p["we_up"])
    return torch.bmm(h, p["we_down"])


def _pair_rows(out: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each (token, k) pair's row of the expert outputs ``out`` (R, D) at
    its ``slot`` (zeros at the trash slot R), the reference's
    ``out[slot]``, as a scatter of every slot's row to the pair that
    filled it (empty slots, zero rows, to a trash pair): its gradient is
    a gather, where the gather's is an accumulating scatter in which
    every dropped pair's trash index serialises on the card."""
    n, rows = slot.numel(), out.shape[0]
    pair = torch.full((rows + 1,), n, device=out.device).index_put_(
        (slot,), torch.arange(n, device=out.device))[:rows]
    return out.new_zeros(n + 1, out.shape[1]).index_put((pair,), out)[:n]


def _dispatch(x: torch.Tensor, slot: torch.Tensor, rows: int,
              k: int) -> torch.Tensor:
    """The (rows, D) expert buffer: each token's row once per (token, k)
    pair, token-major (the reference's ``x[token_of]``), at the pair's
    slot; trash-slot pairs land on a row past ``rows`` that is cut off.
    The rows go in as an expand, whose gradient is a sum over k in a
    fixed order, where a gather's is a scatter-add."""
    t, d = x.shape
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
    return buf[:rows]


def _local_expert_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig,
                      e_total: int, e_index: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts on (T, D) tokens -> (y (T, D), aux).  ``p["we_*"]``
    hold ``e_loc`` of the ``e_total`` (padded) experts, the block
    ``e_index`` (all of them on a single shard): pairs routed to other
    experts write the trash row, and ``y`` is this block's part of the
    output."""
    m = cfg.moe
    t, d = x.shape
    k = m.top_k
    e_loc = p["we_gate"].shape[0]
    cap = _capacity(t, e_total, k, m.capacity_factor)
    weights, ids, aux = route(p["router"], x, cfg)
    slot, _ = dispatch_slots(ids, e_total, cap)
    if e_loc < e_total:
        # this block owns the slots [e0 * cap, (e0 + e_loc) * cap)
        local = slot - e_index * e_loc * cap
        slot = torch.where((local >= 0) & (local < e_loc * cap), local,
                           torch.full_like(local, e_loc * cap))
    ebuf = _dispatch(x, slot, e_loc * cap, k).view(e_loc, cap, d)
    out = _experts(ebuf, p).reshape(e_loc * cap, d)
    return combine(_pair_rows(out, slot) * weights.reshape(-1, 1), k), aux


def _a2a_expert_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig,
                    tp: C.TensorParallel, e_total: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all expert parallelism on this rank's slice (T_loc, D) of
    the tokens -> (its y (T_loc, D), its aux).  Routing, top-k and the
    capacity (over the slice's tokens, per (destination rank, local
    expert)) are the slice's own; the (n, e_loc * cap, D) send buffer
    goes to the experts' owners, which run their (e_loc, n * cap, D)
    buffer (the source ranks' rows side by side, the reference's
    transpose), and a second exchange brings the rows back."""
    m = cfg.moe
    t, d = x.shape
    k, n = m.top_k, tp.size
    e_loc = e_total // n
    cap = _capacity(t, e_total, k, m.capacity_factor)
    weights, ids, aux = route(p["router"], x, cfg)
    slot, _ = dispatch_slots(ids, e_total, cap)
    send = _dispatch(x, slot, e_total * cap, k).view(n, e_loc * cap, d)
    recv = C.all_to_all(send, tp)
    ebuf = recv.view(n, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n * cap, d)
    out = _experts(ebuf, p)
    back = out.view(e_loc, n, cap, d).transpose(0, 1).reshape(
        n, e_loc * cap, d)
    ret = C.all_to_all(back, tp).view(e_total * cap, d)
    return combine(_pair_rows(ret, slot) * weights.reshape(-1, 1), k), aux


def _expert_parallel(p: Params, flat: torch.Tensor, cfg: ModelConfig,
                     shard_ctx, dispatch: str, mesh_aux: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, C.TensorParallel]:
    """The routed experts over the mesh of ``shard_ctx`` -> (y, aux, the
    ``model`` group).  ``flat`` (T, D), this rank's data shard's tokens,
    is the same on every rank of the group, and so is ``y``.  Every
    collective runs over the ``model`` group but the balance loss's mean
    over the whole mesh, which ``mesh_aux`` False leaves out (aux is then
    this rank's own)."""
    if dispatch not in ("psum", "a2a"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    mesh, axis, batch_axes = shard_ctx
    if axis != "model" or axis in batch_axes:
        raise ValueError(f"moe_block: experts split over {axis!r} with "
                         f"batch axes {batch_axes}; expert parallelism runs "
                         "over the 'model' axis, which the batch must not "
                         "split")
    tp = C.TensorParallel(mesh.group((axis,)), mesh.size((axis,)),
                          mesh.coords[axis])
    e_pad = padded_num_experts(cfg.moe.num_experts)
    if p["we_gate"].shape[0] * tp.size != e_pad:
        raise ValueError(
            f"moe_block: {p['we_gate'].shape[0]} experts on this rank; "
            f"expert parallelism over {tp.size} ranks holds {e_pad} / "
            f"{tp.size} a rank")
    router = p["router"]
    if router.shape[-1] < e_pad:
        router = C.gather_from_tp(router, tp, dim=-1)
    # the router's gradient on each rank is a part: its own experts'
    # pairs (psum) or its own slice's tokens (a2a)
    ep = {"router": C.copy_to_tp(router, tp),
          **{key: p[key] for key in ("we_gate", "we_up", "we_down")}}
    if dispatch == "psum":
        # the tokens' gradient is a part too (under a2a the scatter's
        # backward gathers the slices' instead)
        y, aux = _local_expert_ffn(C.copy_to_tp(flat, tp), ep, cfg, e_pad,
                                   tp.rank)
        y = C.reduce_from_tp(y, tp)
    else:
        if flat.shape[0] % tp.size:
            raise ValueError(f"moe_block: {flat.shape[0]} tokens do not "
                             f"split over the {tp.size} ranks of {axis!r}")
        y, aux = _a2a_expert_ffn(C.scatter_to_tp(flat, tp), ep, cfg, tp,
                                 e_pad)
        y = C.gather_from_tp(y, tp)
    return y, (C.mesh_mean(aux, tp, mesh) if mesh_aux else aux), tp


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
              shard_ctx=None, dispatch: str = "psum", mesh_aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux); on one shard every token of the B x S is
    routed together (the capacity is over all of them).  Shared experts
    (qwen2) add an fp32 sigmoid gate, cast to x's dtype, times their
    gated MLP.

    ``shard_ctx`` = (a ``launch.mesh.TorchMesh``, ``"model"``, the batch
    axes) runs the expert-parallel ``dispatch``, ``"psum"`` or ``"a2a"``
    (see the module doc) on this rank's blocks of the routed experts and
    router; the shared experts' MLP runs on its ffn columns where the
    planner split them over ``model``, as the dense MLP does under TP.
    Serving passes ``mesh_aux`` False: it reads no balance loss, and a
    prefill runs on the data group that holds the prompt's lane alone, so
    the loss's mean over every rank of the mesh would wait on ranks that
    do not run it."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    m = cfg.moe
    tp = None
    if shard_ctx is None:
        y, aux = _local_expert_ffn(flat, p, cfg,
                                   padded_num_experts(m.num_experts))
    else:
        y, aux, tp = _expert_parallel(p, flat, cfg, shard_ctx, dispatch,
                                      mesh_aux)
    if m.num_shared_experts > 0:
        # the gate's weight and input are whole on every rank, and so
        # are their gradients: no collective
        gate = torch.sigmoid(torch.matmul(flat, p["shared_gate"]).float())
        split = tp is not None and \
            p["shared"]["wi_gate"].shape[-1] < m.d_shared_expert
        y = y + gate.to(flat.dtype) * gated_mlp(p["shared"], flat,
                                                tp if split else None)
    return y.reshape(b, s, d), aux
