"""Block application: the counterpart of ``repro/models/transformer.py``
for training and for dense serving (prefill and one-token decode) of
global and sliding-window attention, Mamba-2, RWKV-6, zamba2's
weight-shared attention blocks, the MoE blocks and whisper's encoder and
decoder blocks (LayerNorm, the biased GELU MLP, cross attention over the
encoder's frames); a sliding-window block's cache is a ring of
``min(cache_len, window)`` slots.

``ImplConfig`` carries the execution-strategy fields the train step and
the dense path read.  ``attn_impl`` and ``attn_chunk`` are kept so a plan
moves across unchanged, but the port's attention is always the
flash-attention kernels on CUDA (the plain forward on CPU), whatever they
say: the reference's ``naive``/``chunked``/``pallas`` choice is one of
memory and XLA program size, and the kernels need neither the full score
matrix nor a chunk loop.  The reference's ``scan_chunk`` has no
counterpart: the port's scans are exact at any chunk, and the kernels
keep their own.

Prefill and decode update the dense cache in place: each writes its
block's new state into the cache tensors it is given.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, ENC_ATTN, MAMBA2, MOE, RWKV6,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rw

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class ImplConfig:
    """Execution-strategy knobs of one invocation (the reference's
    defaults)."""
    attn_impl: str = "naive"          # kept for parity; see module doc
    attn_chunk: int = 1024
    remat: str = "full"               # none | dots | full
    # stream the unembed+CE over sequence chunks (0 = monolithic logits)
    loss_chunk: int = 0


# matmuls without batch dims (``torch.matmul`` of a (B, S, d) activation
# by a (d, n) weight reaches ``aten.mm``): the ops whose outputs
# ``remat="dots"`` keeps, as the reference's
# ``dots_with_no_batch_dims_saveable`` keeps its ``dot_general``s
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, policy: str) -> Callable:
    """``"none"`` runs ``fn`` as is; ``"full"`` keeps only its inputs and
    recomputes the rest in the backward (``torch.utils.checkpoint``,
    non-reentrant); ``"dots"`` keeps its inputs and the outputs of its
    matmuls without batch dims, and recomputes the rest -- the attention
    and scan kernels' Functions, norms and elementwise ops -- in the
    backward (selective checkpointing)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        dots = functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=dots)
    raise ValueError(f"unknown remat policy {policy!r}")


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """whisper's LayerNorm with a bias; RMSNorm (the K3 kernel) otherwise."""
    if cfg.family == "audio":
        return L.layer_norm(x, p["g"], p["b"], eps=1e-5)
    return L.rms_norm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# per-kind parameter specs
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> Params:
    if cfg.family == "audio":
        return {"g": L.Spec((cfg.d_model,), ("embed",), std=1.0),
                "b": L.Spec((cfg.d_model,), ("embed",), std=0.0)}
    return {"g": L.rms_norm_spec(cfg.d_model)}


def _attn_mlp_specs(cfg: ModelConfig) -> Params:
    return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
            "ln2": norm_specs(cfg),
            "mlp": L.gated_mlp_specs(cfg.d_model, cfg.d_ff)}


def block_specs(cfg: ModelConfig, kind: str) -> Params:
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        return _attn_mlp_specs(cfg)
    if kind == ENC_ATTN:
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": norm_specs(cfg),
                "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}
    if kind == DEC_ATTN:
        return {"ln1": norm_specs(cfg),
                "attn": attn.attn_specs(cfg, cross=True),
                "ln_cross": norm_specs(cfg), "ln2": norm_specs(cfg),
                "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}
    if kind == MOE:
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": norm_specs(cfg), "moe": moe_mod.moe_specs(cfg)}
    if kind == RWKV6:
        return {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg),
                "rwkv": rw.rwkv6_specs(cfg)}
    if kind == MAMBA2:
        return {"ln1": norm_specs(cfg), "mamba": m2.mamba2_specs(cfg)}
    if kind == ATTN_SHARED:
        # per-application params only (input norm); weights are shared
        return {"ln_in": norm_specs(cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def stack_specs(specs: Params, n: int) -> Params:
    """Every leaf of a spec tree with a leading stacked dim of ``n``, its
    logical axis ``"blocks"``."""
    return {k: (stack_specs(v, n) if isinstance(v, dict)
                else L.Spec((n,) + v.shape, ("blocks",) + L.spec_axes(v),
                            v.std))
            for k, v in specs.items()}


def shared_specs(cfg: ModelConfig) -> Params:
    """Model-level components shared across blocks or ahead of them:
    zamba2's one set of attention weights, phi-3-vision's projection of
    the (stubbed) CLIP patch embeddings, whisper's encoder stack."""
    out: Params = {}
    if ATTN_SHARED in cfg.pattern:
        out["shared_attn"] = _attn_mlp_specs(cfg)
    if cfg.family == "vlm":
        out["img_proj"] = L.Spec((1024, cfg.d_model), (None, "embed"))
    if cfg.is_encdec:
        out["encoder"] = {
            "blocks": stack_specs(block_specs(cfg, ENC_ATTN),
                                  cfg.num_encoder_layers),
            "ln_f": norm_specs(cfg)}
    return out


# ---------------------------------------------------------------------------
# dense-cache specs per kind
# ---------------------------------------------------------------------------

def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int) -> Params:
    if kind in (ATTN_GLOBAL, MOE, ATTN_SHARED):
        return attn.kv_cache_specs(cfg, batch, cache_len)
    if kind == DEC_ATTN:
        specs = attn.kv_cache_specs(cfg, batch, cache_len)
        kvs = (batch, cfg.num_kv_heads, cfg.encoder_seq_len, cfg.head_dim)
        specs["cross_k"] = L.CacheSpec(kvs, torch.bfloat16)
        specs["cross_v"] = L.CacheSpec(kvs, torch.bfloat16)
        return specs
    if kind == ATTN_LOCAL:
        return attn.kv_cache_specs(cfg, batch, cache_len,
                                   window=cfg.sliding_window)
    if kind == RWKV6:
        return rw.rwkv_state_specs(cfg, batch)
    if kind == MAMBA2:
        return m2.mamba_state_specs(cfg, batch)
    raise ValueError(f"{kind!r} blocks keep no dense cache")


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
    if kind == MOE:
        # every lane of the batch routes, idle ones too, as in the
        # reference (B <= 8 tokens: no expert reaches its capacity of 8)
        h = apply_norm(cfg, p["ln1"], x)
        y, cache = attn.self_attention_decode(p["attn"], h, cache, pos, cfg)
        x = x + y
        h = apply_norm(cfg, p["ln2"], x)
        y, _ = moe_mod.moe_block(p["moe"], h, cfg)
        return x + y, cache
    if kind == DEC_ATTN:
        h = apply_norm(cfg, p["ln1"], x)
        y, _ = attn.self_attention_decode(p["attn"], h, cache, pos, cfg,
                                          prefix="self_")
        x = x + y
        # the query over all of the encoder's frames (K4 at valid length T)
        h = apply_norm(cfg, p["ln_cross"], x)
        q = attn.project(h, p["attn"]["cross_wq"])
        o = attn.gqa_decode_sdpa(q, cache["cross_k"], cache["cross_v"],
                                 cache["cross_k"].shape[2])
        x = x + attn.attn_out(p["attn"], o, prefix="cross_")
        h = apply_norm(cfg, p["ln2"], x)
        return x + L.mlp(p["mlp"], h), cache
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
    raise ValueError(f"{kind!r} blocks have no decode step")


def apply_block_prefill(cfg: ModelConfig, kind: str, p: Params,
                        x: torch.Tensor, shared: Params, cache: Params,
                        enc_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Params]:
    """A whole prompt through one block.  x: (B, S, d); ``cache`` holds
    this block's (B, ...) decode state, which is overwritten in place with
    the state after the prompt (KV rows past S zeroed; a sliding-window
    block's ring holds the prompt's last ``window`` positions; a whisper
    decoder block's cross K/V are the encoder output's).  ``enc_out`` is
    the encoder's output (B, T, d) for decoder blocks.  Returns (x,
    cache)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL, MOE):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        h = apply_norm(cfg, p["ln1"], x)
        y, kv = attn.self_attention_prefill(p["attn"], h, cfg, window=window)
        x = x + y
        h = apply_norm(cfg, p["ln2"], x)
        if kind == MOE:
            y, _ = moe_mod.moe_block(p["moe"], h, cfg)
        else:
            y = L.gated_mlp(p["mlp"], h)
        return x + y, _store_kv(cache, kv, window)
    if kind == DEC_ATTN:
        h = apply_norm(cfg, p["ln1"], x)
        y, kv = attn.self_attention_prefill(p["attn"], h, cfg,
                                            prefix="self_")
        x = x + y
        h = apply_norm(cfg, p["ln_cross"], x)
        enc_kv = attn.encode_cross_kv(p["attn"], enc_out)
        x = x + attn.cross_attention(p["attn"], h, enc_kv, cfg)
        h = apply_norm(cfg, p["ln2"], x)
        _store_kv(cache, kv)
        cache["cross_k"].copy_(enc_kv["k"].transpose(1, 2))
        cache["cross_v"].copy_(enc_kv["v"].transpose(1, 2))
        return x + L.mlp(p["mlp"], h), cache
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
    raise ValueError(f"{kind!r} blocks have no prefill")


def apply_encoder_block(cfg: ModelConfig, p: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """One of whisper's encoder layers over the frames (B, T, d):
    bidirectional self attention (the flash-attention forward, non-causal)
    and the biased GELU MLP, each behind a LayerNorm."""
    h = apply_norm(cfg, p["ln1"], x)
    q = attn.project(h, p["attn"]["wq"])
    k = attn.project(h, p["attn"]["wk"])
    v = attn.project(h, p["attn"]["wv"])
    x = x + attn.attn_out(p["attn"], attn.sdpa(q, k, v, causal=False))
    h = apply_norm(cfg, p["ln2"], x)
    return x + L.mlp(p["mlp"], h)


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
                    window: int, tp=None) -> torch.Tensor:
    """With ``tp``, the attention and the MLP each run this rank's heads
    or ffn columns where the planner split them (the residual stream and
    the norms stay whole on every rank)."""
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn.self_attention_train(p["attn"], h, cfg, causal=True,
                                      window=window, tp=tp)
    h = apply_norm(cfg, p["ln2"], x)
    split = tp is not None and p["mlp"]["wi_gate"].shape[-1] < cfg.d_ff
    return x + L.gated_mlp(p["mlp"], h, tp if split else None)


def _shared_attn_apply(cfg: ModelConfig, sp: Params,
                       x: torch.Tensor) -> torch.Tensor:
    """zamba2's shared attention block on the normed input ``x``: its
    attention (head dim 80 through the flash kernels) and gated MLP, the
    residual left to the caller."""
    h = apply_norm(cfg, sp["ln1"], x)
    y = attn.self_attention_train(sp["attn"], h, cfg, causal=True)
    h2 = apply_norm(cfg, sp["ln2"], x + y)
    return y + L.gated_mlp(sp["mlp"], h2)


def apply_block_train(cfg: ModelConfig, kind: str, p: Params,
                      x: torch.Tensor, shared: Optional[Params] = None,
                      enc_out: Optional[torch.Tensor] = None, tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of kind ``kind`` -> (x, aux): ``aux`` is the MoE balance
    loss, an fp32 0 for every other kind.  ``shared`` holds the model's
    shared components (zamba2's ``shared_attn``), whose gradients
    accumulate over every block that applies them; ``enc_out`` is
    whisper's encoder output (B, T, d), whose cross K/V a decoder block
    projects inside the block, so that a recompute runs them again.
    ``tp``, a ``TensorParallel`` group, reaches the attention and MLP
    blocks only (``Model`` refuses it for a stack of other kinds)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        x = _attn_mlp_block(cfg, p, x, window=window, tp=tp)
    elif kind == DEC_ATTN:
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.self_attention_train(p["attn"], h, cfg, causal=True,
                                          prefix="self_")
        h = apply_norm(cfg, p["ln_cross"], x)
        enc_kv = attn.encode_cross_kv(p["attn"], enc_out)
        x = x + attn.cross_attention(p["attn"], h, enc_kv, cfg)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + L.mlp(p["mlp"], h)
    elif kind == MOE:
        h = apply_norm(cfg, p["ln1"], x)
        x = x + attn.self_attention_train(p["attn"], h, cfg, causal=True)
        h = apply_norm(cfg, p["ln2"], x)
        y, aux = moe_mod.moe_block(p["moe"], h, cfg)
        x = x + y
    elif kind == RWKV6:
        h = apply_norm(cfg, p["ln1"], x)
        x = x + rw.time_mix_train(p["rwkv"], h, cfg)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + rw.channel_mix(p["rwkv"], h)
    elif kind == MAMBA2:
        h = apply_norm(cfg, p["ln1"], x)
        x = x + m2.mamba2_train(p["mamba"], h, cfg)
    elif kind == ATTN_SHARED:
        h = apply_norm(cfg, p["ln_in"], x)
        x = x + _shared_attn_apply(cfg, shared["shared_attn"], h)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x, aux
