"""Attention projections, scaled-dot-product attention and the dense KV
cache.

Counterpart of ``repro/models/attention.py`` for what paged serving,
dense serving and training run: ``project_qkv`` (with qk-norm and RoPE),
``sdpa``, ``attn_out``, ``self_attention_train``, the dense path's
``kv_cache_specs``, ``gqa_decode_sdpa``,
``self_attention_decode`` and ``self_attention_prefill``, and whisper's
cross attention (``encode_cross_kv``, ``cross_attention``), in the
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
rank's heads when the planner split them (:func:`tp_weights`).
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
from repro_torch.sharding.collectives import (TensorParallel, copy_to_tp,
                                              reduce_from_tp)

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


def tp_weights(p: Params, cfg: ModelConfig, tp: TensorParallel) -> Params:
    """The weights of this rank's q heads when the planner split them
    over the group (``p["wq"]`` holds ``h`` of ``cfg.num_heads``): the K/V
    heads they read -- this rank's own when the K/V heads were split too,
    else the ones its q heads map to, picked from the replicated ``wk`` /
    ``wv`` (KV heads that do not divide the group) -- and the qk-norm
    gains.  A replicated weight applied to this rank's heads only enters
    through :func:`copy_to_tp`, so its gradient is summed over the
    group."""
    h, kv = p["wq"].shape[1], p["wk"].shape[1]
    out = dict(p)
    if kv == cfg.num_kv_heads:
        g = cfg.num_heads // cfg.num_kv_heads
        h0 = tp.rank * h
        if h % g and g % h:
            raise ValueError(f"{cfg.name}: {h} local q heads of group size "
                             f"{g} do not pair with whole K/V heads")
        sel = slice(h0 // g, h0 // g + max(h // g, 1))
        for name in ("wk", "wv"):
            out[name] = copy_to_tp(p[name], tp)[:, sel]
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = copy_to_tp(p[name], tp)
    return out


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
    split = tp is not None and p[prefix + "wq"].shape[1] < cfg.num_heads
    if split:
        p, x = tp_weights(p, cfg, tp), copy_to_tp(x, tp)
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


def self_attention_decode(p: Params, x: torch.Tensor, cache: Params,
                          pos: int, cfg: ModelConfig, *, window: int = 0,
                          prefix: str = "") -> Tuple[torch.Tensor, Params]:
    """One-token decode at the shared position ``pos``.  x: (B, 1, d);
    cache k/v: (B, KV, S, hd), written in place at slot ``pos`` for every
    lane, or at ``pos % S`` when ``window > 0`` (a ring of S = min(cache_len,
    window) slots).  Returns (out, cache).

    Every lane attends over slots ``[0, min(pos + 1, S))``.  For the ring
    that is the reference's mask: slot i holds position ``pos - ((pos -
    i) % S)``, which always lies in ``(pos - S, pos]`` with ``S <=
    window``, so the window never masks a written slot, and a slot is
    written once ``pos >= i``.  The slots are not in position order, and
    need not be: RoPE was applied before the write."""
    s_cache = cache["k"].shape[2]
    if window > 0:
        slot = pos % max(s_cache, 1)
    elif 0 <= pos < s_cache:
        slot = pos
    else:
        raise ValueError(f"decode position {pos} outside the dense cache of "
                         f"{s_cache} slots")
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k, v = project_qkv(p, x, cfg, positions, prefix)
    cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)     # in place
    cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
    o = gqa_decode_sdpa(q, cache["k"], cache["v"], min(pos + 1, s_cache))
    return attn_out(p, o, prefix), cache


def self_attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                           window: int = 0, prefix: str = ""
                           ) -> Tuple[torch.Tensor, Params]:
    """Forward over a prompt at positions 0..S-1 -> (out (B, S, d), its KV
    {"k", "v"} laid out (B, KV, S', hd)).  With ``window > 0`` and S >
    window the KV is the prompt's last ``window`` entries, rolled by ``S %
    window`` so that position p sits at slot ``p % window`` (the ring
    decode's layout), as the reference keeps it."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = project_qkv(p, x, cfg, positions, prefix)
    o = sdpa(q, k, v, causal=True, window=window)
    if window > 0 and s > window:
        k = torch.roll(k[:, -window:], s % window, dims=1)
        v = torch.roll(v[:, -window:], s % window, dims=1)
    return attn_out(p, o, prefix), {"k": k.transpose(1, 2),
                                    "v": v.transpose(1, 2)}


# ---------------------------------------------------------------------------
# cross attention (whisper's decoder)
# ---------------------------------------------------------------------------

def encode_cross_kv(p: Params, enc_out: torch.Tensor) -> Params:
    """The encoder output's cross K and V, (B, T, KV, hd) each."""
    return {"k": project(enc_out, p["cross_wk"]),
            "v": project(enc_out, p["cross_wv"])}


def cross_attention(p: Params, x: torch.Tensor, enc_kv: Params,
                    cfg: ModelConfig) -> torch.Tensor:
    """Every query row over every encoder frame (non-causal; the
    flash-attention kernels at Sq = prompt, Sk = frames, the backward
    ones too when a gradient is taken)."""
    q = project(x, p["cross_wq"])
    o = sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
    return attn_out(p, o, prefix="cross_")
