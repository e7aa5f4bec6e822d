"""Attention projections, scaled-dot-product attention and the dense KV
cache.

Counterpart of ``repro/models/attention.py`` for what paged serving,
dense serving and training run: ``project_qkv`` (with qk-norm and RoPE),
``sdpa``, ``attn_out``, ``self_attention_train``, the dense path's
``kv_cache_specs``, ``gqa_decode_sdpa``,
``self_attention_decode`` and ``self_attention_prefill``, and whisper's
cross attention (``encode_cross_kv``, ``cross_attention``,
``cross_attention_decode``), in the
reference's layouts: activations (B, S, H, hd), the dense cache (B, KV,
S, hd).  ``prefix`` selects a decoder block's ``self_`` or ``cross_``
weights, as in the reference.  ``sdpa`` goes through the Hopper
flash-attention kernels on CUDA tensors -- the forward kernel, and the
two backward kernels when a gradient is taken (``FlashAttention``; the
forward kernel's wrapper alone when none is, as in serving) -- and
through the plain forward, in the reference's rounding order and
differentiated by autograd, on CPU tensors.  ``gqa_decode_sdpa`` goes
through the decode-attention kernel (its plain version on CPU tensors).
GQA is handled inside the kernels, without expanding KV heads.

Where the reference returns an updated copy of the dense cache, the port
writes the new token's K and V into the cache tensors in place.

``self_attention_train`` with a :class:`TensorParallel` group runs this
rank's heads when the planner split them (:func:`tp_weights`), and so do
``self_attention_decode``, ``self_attention_prefill`` and whisper's cross
attention under a serving plan of a mesh: the rank's query and KV heads,
the output projection's partial sums summed over the group.  Where the
dense cache's stored layout splits its sequence dim over mesh axes (the
reference's flash-decode materialization), ``self_attention_decode``
takes the reference's ``shard_ctx``: only the rank that owns the new
token's slot writes it (:func:`seqshard_cache_update`), each rank runs
the decode-attention kernel over its own block up to its part of the
valid length, returning its partial softmax state (the output and its
log-sum-exp), and the ranks merge those
(``collectives.combine_softmax_parts``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_fwd)
from repro_torch.models.layers import (CacheSpec, Spec, apply_rope,
                                       needs_grad, rms_norm, rms_norm_spec)
from repro_torch.sharding.collectives import (TensorParallel,
                                              combine_softmax_parts,
                                              copy_to_tp, reduce_from_tp)

Params = Dict[str, Any]


def attn_specs(cfg: ModelConfig, cross: bool = False) -> Params:
    """The projections; with ``cross`` a decoder block's two sets, under
    ``self_`` and ``cross_`` (the cross set has no qk-norm)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj():
        return {"wq": Spec((d, h, hd), ("embed", "q_heads", "head_dim")),
                "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
                "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
                "wo": Spec((h, hd, d), ("q_heads", "head_dim", "embed"))}

    p = proj()
    if cfg.use_qk_norm:
        p["q_norm"] = rms_norm_spec(hd)
        p["k_norm"] = rms_norm_spec(hd)
    if cross:
        p = {f"self_{k}": v for k, v in p.items()}
        p.update({f"cross_{k}": v for k, v in proj().items()})
    return p


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dnh->bsnh') as one matmul over the flattened heads."""
    d, n, hd = w.shape
    return torch.matmul(x, w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor,
                prefix: str = "") -> Tuple[torch.Tensor, ...]:
    q = project(x, p[prefix + "wq"])
    k = project(x, p[prefix + "wk"])
    v = project(x, p[prefix + "wv"])
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  Query
    row i sits at position ``q_offset + i``, key j at position j."""
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type != "cpu" and needs_grad(q, k, v):
        o = FlashAttention.apply(q, k, v, causal, window, q_offset)
    else:
        o, _ = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return o.transpose(1, 2)


def attn_out(p: Params, o: torch.Tensor, prefix: str = "") -> torch.Tensor:
    w = p[prefix + "wo"]
    h, hd, d = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * hd), w.reshape(h * hd, d))


def tp_weights(p: Params, cfg: ModelConfig, tp: TensorParallel,
               prefix: str = "") -> Params:
    """The weights of this rank's q heads when the planner split them
    over the group (``p[prefix + "wq"]`` holds ``h`` of ``cfg.num_heads``;
    ``prefix`` a decoder block's ``self_`` or ``cross_`` set): the K/V
    heads they read -- this rank's own when the K/V heads were split too,
    else the ones its q heads map to, picked from the replicated ``wk`` /
    ``wv`` (KV heads that do not divide the group) -- and the qk-norm
    gains.  A replicated weight applied to this rank's heads only enters
    through :func:`copy_to_tp`, so its gradient is summed over the
    group."""
    h, kv = p[prefix + "wq"].shape[1], p[prefix + "wk"].shape[1]
    out = dict(p)
    if kv == cfg.num_kv_heads:
        g = cfg.num_heads // cfg.num_kv_heads
        h0 = tp.rank * h
        if h % g and g % h:
            raise ValueError(f"{cfg.name}: {h} local q heads of group size "
                             f"{g} do not pair with whole K/V heads")
        sel = slice(h0 // g, h0 // g + max(h // g, 1))
        for name in (prefix + "wk", prefix + "wv"):
            out[name] = copy_to_tp(p[name], tp)[:, sel]
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = copy_to_tp(p[name], tp)
    return out


def rank_heads(p: Params, cfg: ModelConfig, tp: Optional[TensorParallel],
               prefix: str = "") -> Tuple[Params, bool]:
    """(``p`` for this rank's heads, whether they are split): the weights
    of :func:`tp_weights` when ``tp`` is given and the planner split the
    q heads over it, else ``p`` as it is."""
    split = tp is not None and p[prefix + "wq"].shape[1] < cfg.num_heads
    return (tp_weights(p, cfg, tp, prefix) if split else p), split


def self_attention_train(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         causal: bool = True, window: int = 0,
                         prefix: str = "",
                         tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x: (B, S, d) at positions 0..S-1 -> (B, S, d): projections, RoPE,
    attention (the kernels on CUDA, whatever the reference's ``impl``
    would pick), and the output projection; ``prefix`` picks a decoder
    block's ``self_`` weights.  With ``tp`` and split heads, this rank's
    heads: the input enters through :func:`copy_to_tp` and the output
    projection's partial sums are summed over the group."""
    positions = torch.arange(x.shape[1], device=x.device)
    p, split = rank_heads(p, cfg, tp, prefix)
    if split:
        x = copy_to_tp(x, tp)
    q, k, v = project_qkv(p, x, cfg, positions, prefix)
    o = sdpa(q, k, v, causal=causal, window=window)
    out = attn_out(p, o, prefix)
    return reduce_from_tp(out, tp) if split else out


# ---------------------------------------------------------------------------
# dense serving: a per-slot KV cache laid out (B, KV, S, hd)
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                   window: int = 0, dtype=torch.bfloat16) -> Params:
    """One layer's dense KV cache, laid out (B, KV, S, hd) as the
    reference's (the decode kernel reads each (lane, KV head) run of S
    keys contiguously); a ring of ``min(cache_len, window)`` slots when
    ``window > 0``."""
    s = min(cache_len, window) if window > 0 else cache_len
    shape = (batch, cfg.num_kv_heads, s, cfg.head_dim)
    return {"k": CacheSpec(shape, dtype), "v": CacheSpec(shape, dtype)}


def gqa_decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len) -> torch.Tensor:
    """Decode attention without expanding KV heads.  q: (B, 1, H, hd); k,
    v: (B, KV, S, hd); valid_len: scalar or (B,) int32 -- each lane
    attends over cache positions ``[0, valid_len)``.  Returns (B, 1, H,
    hd).  (The reference passes a (S,) validity mask; on its dense path
    that mask is always a prefix, ``idx <= pos``.)"""
    return decode_attention(q[:, 0], k, v, valid_len)[:, None]


def seqshard_cache_update(cache: torch.Tensor, new: torch.Tensor, slot: int,
                          mesh, seq_axes) -> torch.Tensor:
    """Write one token row into a sequence-sharded cache, in place and
    without a collective.  cache: this rank's block (B, KV, S_local, hd)
    of a cache whose S dim is split over ``seq_axes`` (blocks numbered by
    the rank's index along them, the first axis major, as the reference
    numbers them); new: (B, KV, hd); slot: the global row.  Only the rank
    whose block holds ``slot`` writes it, at ``slot - offset``."""
    s_local = cache.shape[2]
    off = mesh.index(seq_axes) * s_local
    if off <= slot < off + s_local:
        cache[:, :, slot - off] = new.to(cache.dtype)
    return cache


def self_attention_decode(p: Params, x: torch.Tensor, cache: Params,
                          pos: int, cfg: ModelConfig, *, window: int = 0,
                          prefix: str = "",
                          tp: Optional[TensorParallel] = None,
                          shard_ctx=None) -> Tuple[torch.Tensor, Params]:
    """One-token decode at the shared position ``pos``.  x: (B, 1, d);
    cache k/v: (B, KV, S, hd), written in place at slot ``pos`` for every
    lane, or at ``pos % S`` when ``window > 0`` (a ring of S = min(cache_len,
    window) slots).  Returns (out, cache).

    Every lane attends over slots ``[0, min(pos + 1, S))``.  For the ring
    that is the reference's mask: slot i holds position ``pos - ((pos -
    i) % S)``, which always lies in ``(pos - S, pos]`` with ``S <=
    window``, so the window never masks a written slot, and a slot is
    written once ``pos >= i``.  The slots are not in position order, and
    need not be: RoPE was applied before the write.

    With ``tp`` and split heads, this rank's query heads and the KV heads
    they read (the cache holds those KV heads), the output projection's
    partial sums summed over the group.  ``shard_ctx`` (mesh, seq_axes,
    batch_axes) says that the cache holds this rank's block of S, split
    over ``seq_axes``: S above is then the whole cache's, the new row goes
    to its owner (:func:`seqshard_cache_update`), the rank attends over
    its block's part of ``[0, min(pos + 1, S))`` (none at all early in a
    sequence: out 0 and lse -inf), and the ranks' partial softmax states
    are combined over ``seq_axes``."""
    s_local = cache["k"].shape[2]
    mesh = seq_axes = None
    s_cache = s_local
    if shard_ctx is not None:
        mesh, seq_axes = shard_ctx[0], tuple(shard_ctx[1])
        s_cache = s_local * mesh.size(seq_axes)
    if window > 0:
        slot = pos % max(s_cache, 1)
    elif 0 <= pos < s_cache:
        slot = pos
    else:
        raise ValueError(f"decode position {pos} outside the dense cache of "
                         f"{s_cache} slots")
    p, split = rank_heads(p, cfg, tp, prefix)
    if split and seq_axes is not None and "model" in seq_axes:
        raise NotImplementedError(
            f"{cfg.name}: the q heads are split over 'model' and the cache's "
            f"sequence over {seq_axes}: each rank would need the other "
            "ranks' blocks of its heads' keys (ROADMAP item A8d)")
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k, v = project_qkv(p, x, cfg, positions, prefix)
    if k.shape[2] != cache["k"].shape[1]:
        raise NotImplementedError(
            f"{cfg.name}: this rank's {k.shape[2]} KV heads against a cache "
            f"of {cache['k'].shape[1]}: serving with q heads split over a "
            "group that does not split the KV heads is ROADMAP item A8d")
    if seq_axes is None:
        cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)     # in place
        cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
        o = gqa_decode_sdpa(q, cache["k"], cache["v"], min(pos + 1, s_cache))
    else:
        seqshard_cache_update(cache["k"], k[:, 0], slot, mesh, seq_axes)
        seqshard_cache_update(cache["v"], v[:, 0], slot, mesh, seq_axes)
        off = mesh.index(seq_axes) * s_local
        valid = min(max(min(pos + 1, s_cache) - off, 0), s_local)
        o, lse = decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                                  return_lse=True)
        o = combine_softmax_parts(o, lse, mesh, seq_axes)[:, None].to(q.dtype)
    out = attn_out(p, o, prefix)
    return (reduce_from_tp(out, tp) if split else out), cache


def self_attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                           window: int = 0, prefix: str = "",
                           tp: Optional[TensorParallel] = None
                           ) -> Tuple[torch.Tensor, Params]:
    """Forward over a prompt at positions 0..S-1 -> (out (B, S, d), its KV
    {"k", "v"} laid out (B, KV, S', hd)).  With ``window > 0`` and S >
    window the KV is the prompt's last ``window`` entries, rolled by ``S %
    window`` so that position p sits at slot ``p % window`` (the ring
    decode's layout), as the reference keeps it.  With ``tp`` and split
    heads, this rank's heads and the KV heads they read, the output
    projection's partial sums summed over the group; a cache that splits
    its sequence keeps the rank's block of the positions
    (``transformer._store_kv``)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    p, split = rank_heads(p, cfg, tp, prefix)
    q, k, v = project_qkv(p, x, cfg, positions, prefix)
    o = sdpa(q, k, v, causal=True, window=window)
    if window > 0 and s > window:
        k = torch.roll(k[:, -window:], s % window, dims=1)
        v = torch.roll(v[:, -window:], s % window, dims=1)
    out = attn_out(p, o, prefix)
    return (reduce_from_tp(out, tp) if split else out), \
        {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}


# ---------------------------------------------------------------------------
# cross attention (whisper's decoder)
# ---------------------------------------------------------------------------

def encode_cross_kv(p: Params, enc_out: torch.Tensor,
                    cfg: Optional[ModelConfig] = None,
                    tp: Optional[TensorParallel] = None) -> Params:
    """The encoder output's cross K and V, (B, T, KV, hd) each; with
    ``tp`` (and ``cfg``) and split heads, the KV heads this rank's cross q
    heads read (``enc_out``, whole on every rank, entering through
    :func:`copy_to_tp`)."""
    split = False
    if tp is not None:
        p, split = rank_heads(p, cfg, tp, "cross_")
    if split:
        enc_out = copy_to_tp(enc_out, tp)
    return {"k": project(enc_out, p["cross_wk"]),
            "v": project(enc_out, p["cross_wv"])}


def cross_attention(p: Params, x: torch.Tensor, enc_kv: Params,
                    cfg: ModelConfig,
                    tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Every query row over every encoder frame (non-causal; the
    flash-attention kernels at Sq = prompt, Sk = frames, the backward
    ones too when a gradient is taken).  With ``tp`` and split heads,
    this rank's cross q heads over ``enc_kv``'s heads (its
    :func:`encode_cross_kv`), the output projection's partial sums summed
    over the group."""
    p, split = rank_heads(p, cfg, tp, "cross_")
    if split:
        x = copy_to_tp(x, tp)
    q = project(x, p["cross_wq"])
    o = sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
    out = attn_out(p, o, prefix="cross_")
    return reduce_from_tp(out, tp) if split else out


def cross_attention_decode(p: Params, x: torch.Tensor, cache: Params,
                           cfg: ModelConfig,
                           tp: Optional[TensorParallel] = None
                           ) -> torch.Tensor:
    """One query row (B, 1, d) over all of the encoder's frames in the
    cache's ``cross_k`` / ``cross_v`` (B, KV, T, hd): the decode-attention
    kernel at valid length T.  With ``tp`` and split heads, this rank's
    cross q heads over the cache's KV heads (the rank's, as the plan's
    cache layout splits them), the output projection's partial sums
    summed over the group."""
    p, split = rank_heads(p, cfg, tp, "cross_")
    q = project(x, p["cross_wq"])
    k, v = cache["cross_k"], cache["cross_v"]
    if split and p["cross_wk"].shape[1] != k.shape[1]:
        raise NotImplementedError(
            f"{cfg.name}: this rank's {p['cross_wk'].shape[1]} cross KV "
            f"heads against a cache of {k.shape[1]}: serving with q heads "
            "split over a group that does not split the KV heads is "
            "ROADMAP item A8d")
    o = gqa_decode_sdpa(q, k, v, k.shape[2])
    out = attn_out(p, o, prefix="cross_")
    return reduce_from_tp(out, tp) if split else out
