"""Attention projections, scaled-dot-product attention and the dense KV
cache.

Counterpart of ``repro/models/attention.py`` for what paged serving,
dense serving and training run: ``project_qkv`` (with qk-norm and RoPE),
``sdpa``, ``attn_out``, ``self_attention_train``, and the dense path's
``kv_cache_specs``, ``gqa_decode_sdpa``,
``self_attention_decode`` and ``self_attention_prefill``, in the
reference's layouts: activations (B, S, H, hd), the dense cache (B, KV,
S, hd).  ``sdpa`` goes through the Hopper flash-attention kernels on CUDA
tensors -- the forward kernel, and the two backward kernels when a
gradient is taken (``FlashAttention``; the forward kernel's wrapper alone
when none is, as in serving) -- and through the plain forward, in the
reference's rounding order and differentiated by autograd, on CPU
tensors.  ``gqa_decode_sdpa`` goes through the decode-attention kernel
(its plain version on CPU tensors).  GQA is handled inside the kernels,
without expanding KV heads.

Where the reference returns an updated copy of the dense cache, the port
writes the new token's K and V into the cache tensors in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_fwd)
from repro_torch.models.layers import (CacheSpec, Spec, apply_rope,
                                       needs_grad, rms_norm, rms_norm_spec)

Params = Dict[str, Any]


def attn_specs(cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": Spec((d, h, hd)), "wk": Spec((d, kv, hd)),
         "wv": Spec((d, kv, hd)), "wo": Spec((h, hd, d))}
    if cfg.use_qk_norm:
        p["q_norm"] = rms_norm_spec(hd)
        p["k_norm"] = rms_norm_spec(hd)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dnh->bsnh') as one matmul over the flattened heads."""
    d, n, hd = w.shape
    return torch.matmul(x, w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
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


def attn_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    h, hd, d = p["wo"].shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * hd),
                        p["wo"].reshape(h * hd, d))


def self_attention_train(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """x: (B, S, d) at positions 0..S-1 -> (B, S, d): projections, RoPE,
    attention (the kernels on CUDA, whatever the reference's ``impl``
    would pick), and the output projection."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = project_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, causal=causal, window=window)
    return attn_out(p, o)


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
                          pos: int, cfg: ModelConfig, *, window: int = 0
                          ) -> Tuple[torch.Tensor, Params]:
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
    q, k, v = project_qkv(p, x, cfg, positions)
    cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)     # in place
    cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
    o = gqa_decode_sdpa(q, cache["k"], cache["v"], min(pos + 1, s_cache))
    return attn_out(p, o), cache


def self_attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                           window: int = 0) -> Tuple[torch.Tensor, Params]:
    """Forward over a prompt at positions 0..S-1 -> (out (B, S, d), its KV
    {"k", "v"} laid out (B, KV, S', hd)).  With ``window > 0`` and S >
    window the KV is the prompt's last ``window`` entries, rolled by ``S %
    window`` so that position p sits at slot ``p % window`` (the ring
    decode's layout), as the reference keeps it."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = project_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, causal=True, window=window)
    if window > 0 and s > window:
        k = torch.roll(k[:, -window:], s % window, dims=1)
        v = torch.roll(v[:, -window:], s % window, dims=1)
    return attn_out(p, o), {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
