"""Block application: the counterpart of ``repro/models/transformer.py``
for training (global and sliding-window attention blocks) and for dense
serving (prefill and one-token decode of global and sliding-window
attention, Mamba-2, RWKV-6 and zamba2's weight-shared attention blocks;
a sliding-window block's cache is a ring of ``min(cache_len, window)``
slots).

``ImplConfig`` carries the execution-strategy fields the train step and
the dense path read.  ``attn_impl`` and ``attn_chunk`` are kept so a plan
moves across unchanged, but the port's attention is always the
flash-attention kernels on CUDA (the plain forward on CPU), whatever they
say: the reference's ``naive``/``chunked``/``pallas`` choice is one of
memory and XLA program size, and the kernels need neither the full score
matrix nor a chunk loop.

Prefill and decode update the dense cache in place: each writes its
block's new state into the cache tensors it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, ENC_ATTN, MAMBA2, MOE, RWKV6,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rw

Params = Dict[str, Any]

# block kinds the port does not train yet, and the slice that brings each;
# the recurrent and shared-attention kinds already serve (dense backend)
_LATER = {
    MOE: "the MoE family's slice",
    RWKV6: "the later slice that trains the RWKV-6 family",
    MAMBA2: "the later slice that trains the Mamba-2/zamba2 family",
    ATTN_SHARED: "the later slice that trains the Mamba-2/zamba2 family",
    ENC_ATTN: "the encoder-decoder (whisper) slice",
    DEC_ATTN: "the encoder-decoder (whisper) slice",
}
_SERVED_ONLY = (RWKV6, MAMBA2, ATTN_SHARED)


@dataclasses.dataclass(frozen=True)
class ImplConfig:
    """Execution-strategy knobs of one invocation (the reference's
    defaults)."""
    attn_impl: str = "naive"          # kept for parity; see module doc
    attn_chunk: int = 1024
    remat: str = "full"               # none | full  ("dots": later slice)
    # stream the unembed+CE over sequence chunks (0 = monolithic logits)
    loss_chunk: int = 0


def _remat(fn: Callable, policy: str) -> Callable:
    """``"none"`` runs ``fn`` as is; ``"full"`` keeps only its inputs and
    recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        raise ValueError("remat='dots' (save the matmul outputs, recompute "
                         "the rest) comes with a later slice of the port; "
                         "use 'none' or 'full'")
    raise ValueError(f"unknown remat policy {policy!r}")


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# per-kind parameter specs
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> Params:
    return {"g": L.rms_norm_spec(cfg.d_model)}


def _attn_mlp_specs(cfg: ModelConfig) -> Params:
    return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
            "ln2": norm_specs(cfg),
            "mlp": L.gated_mlp_specs(cfg.d_model, cfg.d_ff)}


def block_specs(cfg: ModelConfig, kind: str) -> Params:
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        return _attn_mlp_specs(cfg)
    if kind == RWKV6:
        return {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg),
                "rwkv": rw.rwkv6_specs(cfg)}
    if kind == MAMBA2:
        return {"ln1": norm_specs(cfg), "mamba": m2.mamba2_specs(cfg)}
    if kind == ATTN_SHARED:
        # per-application params only (input norm); weights are shared
        return {"ln_in": norm_specs(cfg)}
    raise ValueError(f"block kind {kind!r} comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port")


def shared_specs(cfg: ModelConfig) -> Params:
    """Model-level components shared across blocks: zamba2's one set of
    attention weights (the reference's vision and encoder frontends come
    with their slices)."""
    if ATTN_SHARED in cfg.pattern:
        return {"shared_attn": _attn_mlp_specs(cfg)}
    return {}


# ---------------------------------------------------------------------------
# dense-cache specs per kind
# ---------------------------------------------------------------------------

def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int) -> Params:
    if kind in (ATTN_GLOBAL, ATTN_SHARED):
        return attn.kv_cache_specs(cfg, batch, cache_len)
    if kind == ATTN_LOCAL:
        return attn.kv_cache_specs(cfg, batch, cache_len,
                                   window=cfg.sliding_window)
    if kind == RWKV6:
        return rw.rwkv_state_specs(cfg, batch)
    if kind == MAMBA2:
        return m2.mamba_state_specs(cfg, batch)
    raise ValueError(f"a dense cache for {kind!r} blocks comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port")


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Params:
    """Stacked (num_blocks leading dim) cache spec tree."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        leaf = block_cache_specs(cfg, kind, batch, cache_len)
        out[f"p{i}_{kind}"] = {
            k: L.CacheSpec((cfg.num_blocks,) + s.shape, s.dtype)
            for k, s in leaf.items()}
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: torch.device) -> Params:
    return {key: {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                  for k, s in leaf.items()}
            for key, leaf in cache_specs(cfg, batch, cache_len).items()}


# ---------------------------------------------------------------------------
# dense serving: decode-step and prefill block application
# ---------------------------------------------------------------------------

def _store(cache: Params, new: Params) -> Params:
    """Write a block's new decode state into its cache tensors in place."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def apply_block_decode(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, cache: Params, pos: int,
                       shared: Params) -> Tuple[torch.Tensor, Params]:
    """One token through one block at the shared position ``pos``.  x:
    (B, 1, d); ``cache`` holds this block's (B, ...) state and is updated
    in place.  Returns (x, cache)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        h = apply_norm(cfg, p["ln1"], x)
        y, cache = attn.self_attention_decode(p["attn"], h, cache, pos, cfg,
                                              window=window)
        x = x + y
        h = apply_norm(cfg, p["ln2"], x)
        return x + L.gated_mlp(p["mlp"], h), cache
    if kind == RWKV6:
        h = apply_norm(cfg, p["ln1"], x)
        y, tm = rw.time_mix_decode(p["rwkv"], h, cache, cfg)
        x = x + y
        h = apply_norm(cfg, p["ln2"], x)
        cm = rw.channel_mix(p["rwkv"], h, cache["shift_c"])
        _store(cache, dict(tm, shift_c=h))
        return x + cm, cache
    if kind == MAMBA2:
        h = apply_norm(cfg, p["ln1"], x)
        y, new = m2.mamba2_decode(p["mamba"], h, cache, cfg)
        return x + y, _store(cache, new)
    if kind == ATTN_SHARED:
        sp = shared["shared_attn"]
        h = apply_norm(cfg, p["ln_in"], x)
        hh = apply_norm(cfg, sp["ln1"], h)
        y, cache = attn.self_attention_decode(sp["attn"], hh, cache, pos, cfg)
        h2 = apply_norm(cfg, sp["ln2"], h + y)
        return x + y + L.gated_mlp(sp["mlp"], h2), cache
    raise ValueError(f"decoding a {kind!r} block comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port")


def apply_block_prefill(cfg: ModelConfig, kind: str, p: Params,
                        x: torch.Tensor, shared: Params, cache: Params
                        ) -> Tuple[torch.Tensor, Params]:
    """A whole prompt through one block.  x: (B, S, d); ``cache`` holds
    this block's (B, ...) decode state, which is overwritten in place with
    the state after the prompt (KV rows past S zeroed; a sliding-window
    block's ring holds the prompt's last ``window`` positions).  Returns
    (x, cache)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        h = apply_norm(cfg, p["ln1"], x)
        y, kv = attn.self_attention_prefill(p["attn"], h, cfg, window=window)
        x = x + y
        h = apply_norm(cfg, p["ln2"], x)
        return x + L.gated_mlp(p["mlp"], h), _store_kv(cache, kv, window)
    if kind == RWKV6:
        h = apply_norm(cfg, p["ln1"], x)
        y, wkv = rw.time_mix_prefill(p["rwkv"], h, cfg)
        x = x + y
        h2 = apply_norm(cfg, p["ln2"], x)
        x = x + rw.channel_mix(p["rwkv"], h2)
        return x, _store(cache, {"wkv": wkv, "shift_t": h[:, -1:],
                                 "shift_c": h2[:, -1:]})
    if kind == MAMBA2:
        h = apply_norm(cfg, p["ln1"], x)
        y, state = m2.mamba2_prefill(p["mamba"], h, cfg)
        return x + y, _store(cache, state)
    if kind == ATTN_SHARED:
        sp = shared["shared_attn"]
        h = apply_norm(cfg, p["ln_in"], x)
        hh = apply_norm(cfg, sp["ln1"], h)
        y, kv = attn.self_attention_prefill(sp["attn"], hh, cfg)
        h2 = apply_norm(cfg, sp["ln2"], h + y)
        x = x + y + L.gated_mlp(sp["mlp"], h2)
        return x, _store_kv(cache, kv)
    raise ValueError(f"prefilling a {kind!r} block comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port")


def _store_kv(cache: Params, kv: Params, window: int = 0) -> Params:
    """Write prefill KV ((B, KV, S, hd) layout) into the front of the
    cache's sequence axis and zero the rest, in place (the reference's
    ``_pad_cache``).  A ring cache (``window > 0``) of S' slots takes the
    first S' entries of the prefill's ring layout."""
    for name, a in kv.items():
        s, cache_len = a.shape[2], cache[name].shape[2]
        if s > cache_len:
            if window <= 0:
                raise ValueError(f"a prompt of {s} tokens does not fit the "
                                 f"dense cache of {cache_len}")
            a, s = a[:, :, :cache_len], cache_len
        cache[name][:, :, :s].copy_(a)
        cache[name][:, :, s:].zero_()
    return cache


def _attn_mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn.self_attention_train(p["attn"], h, cfg, causal=True,
                                      window=window)
    h = apply_norm(cfg, p["ln2"], x)
    return x + L.gated_mlp(p["mlp"], h)


def apply_block_train(cfg: ModelConfig, kind: str, p: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """One block of kind ``kind``.  (The reference also returns an aux
    loss, which only MoE blocks make.)"""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        return _attn_mlp_block(cfg, p, x, window=window)
    served = (" (it serves already, on the dense backend)"
              if kind in _SERVED_ONLY else "")
    raise ValueError(f"training a {kind!r} block comes with "
                     f"{_LATER.get(kind, 'a later slice')} of the port"
                     f"{served}")
