"""RWKV-6 "Finch" block for training and serving: time-mix with a
data-dependent decay, and channel-mix.

Counterpart of ``repro/models/rwkv6.py``.  The time-mix is a linear
attention with a per-head (hd x hd) state and a per-channel decay
``w_t = exp(-exp(w0 + tanh(x~ W_a) W_b))``::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Training and prefill run the WKV over the whole sequence from a zero state
through the WKV kernel (``wkv_chunked`` -> ``kernels.rwkv6_scan``; its
plain chunked version on CPU tensors), and through its autograd Function
``WKV`` where a gradient is taken.  Both compute the recurrence exactly:
the reference's chunked form clamps a split of the pairwise decay and is
wrong once a chunk's cumulative log-decay falls below -30 (see
``kernels/rwkv6_scan.py``).  Decode is the single-step recurrence in plain
ops.  As in the reference, the token-shift mix coefficients are plain
learned vectors; the decay LoRA is kept.  Training, prefill and decode
under tensor parallelism (``tp``) run this rank's heads and ffn columns;
a serving plan of a mesh splits the WKV state by heads and keeps the
token-shift carries, the block's whole inputs, whole on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import WKV, rwkv6_wkv
from repro_torch.models.layers import (CacheSpec, Spec, group_norm_heads,
                                      needs_grad)
from repro_torch.sharding.collectives import (TensorParallel, copy_to_tp,
                                              gather_from_tp, reduce_from_tp)

Params = Dict[str, Any]

DECAY_LORA = 64


def rwkv6_specs(cfg: ModelConfig) -> Params:
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    return {
        # time-mix
        "mu": Spec((5, d), (None, "embed"), std=0.02),  # r,k,v,w,g shifts
        "wr": Spec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wk": Spec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wv": Spec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wg": Spec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("q_heads", "head_dim", "embed")),
        "w0": Spec((h, hd), ("q_heads", "head_dim"), std=0.02),
        "wa": Spec((d, DECAY_LORA), ("embed", "lora")),  # decay LoRA in
        "wb": Spec((DECAY_LORA, h, hd), ("lora", "q_heads", "head_dim")),
        "bonus_u": Spec((h, hd), ("q_heads", "head_dim"), std=0.02),
        "ln_x": Spec((h, hd), ("q_heads", "head_dim"), std=1.0),
        # channel-mix
        "mu_c": Spec((2, d), (None, "embed"), std=0.02),
        "ck": Spec((d, f), ("embed", "ffn")),
        "cv": Spec((f, d), ("ffn", "embed")),
        "cr": Spec((d, d), ("embed", "embed2")),
    }


def rwkv_state_specs(cfg: ModelConfig, batch: int) -> Params:
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    return {"wkv": CacheSpec((batch, h, hd, hd), torch.float32),
            "shift_t": CacheSpec((batch, 1, d), torch.bfloat16),
            "shift_c": CacheSpec((batch, 1, d), torch.bfloat16)}


def token_shift(x: torch.Tensor,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one; ``prev`` is the last token of the
    previous segment (the decode carry), zeros by default."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dnh->bsnh') as one matmul over the flattened heads."""
    d, n, hd = w.shape
    return torch.matmul(x, w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def decay_logw(p: Params, xw: torch.Tensor,
               tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Data-dependent decay log(w_t) in (-inf, 0).  xw: (B, S, d) -> (B, S,
    H, hd) fp32.  With ``tp``, ``wb`` holds this rank's heads: the LoRA's
    hidden activation, whole on every rank, enters them through
    ``copy_to_tp``."""
    lora = torch.tanh(torch.matmul(xw, p["wa"]))
    if tp is not None:
        lora = copy_to_tp(lora, tp)
    delta = _heads(lora, p["wb"])
    raw = p["w0"].float() + delta.float()
    return -torch.exp(raw)


def time_mix_projections(p: Params, x: torch.Tensor,
                         x_prev: Optional[torch.Tensor], cfg: ModelConfig,
                         tp: Optional[TensorParallel] = None):
    """(r, k, v, g, log w) of ``p``'s heads.  With ``tp`` (``p`` this
    rank's heads), each token-shift mix, whole on every rank, enters this
    rank's heads through ``copy_to_tp``: its gradient is summed over the
    group per element before it reaches ``mu`` and ``x``, which then take
    theirs from one full-width sum, as on one card."""
    xx = token_shift(x, x_prev)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_mix(x, xx, mu[i]) for i in range(5))
    if tp is not None:
        xr, xk, xv, xg = (copy_to_tp(t, tp) for t in (xr, xk, xv, xg))
    r = _heads(xr, p["wr"])
    k = _heads(xk, p["wk"])
    v = _heads(xv, p["wv"])
    g = _heads(xg, p["wg"])
    return r, k, v, g, decay_logw(p, xw, tp)


def wkv_chunked(r, k, v, logw, u):
    """The WKV from a zero state.  r, k, v: (B, S, H, hd); logw: (B, S, H,
    hd) fp32; u: (H, hd).  Returns (o (B, S, H, hd) fp32, final state (B,
    H, hd, hd) fp32).  The kernel reads the model's layout through
    strides; ``WKV`` carries the gradient where one is taken."""
    ins = (r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           logw.transpose(1, 2), u)
    wkv = WKV.apply if needs_grad(*ins) else rwkv6_wkv
    o, state = wkv(*ins)
    return o.transpose(1, 2), state


def _time_mix_out(p: Params, o: torch.Tensor, g: torch.Tensor
                  ) -> torch.Tensor:
    o = group_norm_heads(o, p["ln_x"]) * F.silu(g)
    h, hd, d = p["wo"].shape
    return torch.matmul(o.flatten(-2), p["wo"].reshape(h * hd, d))


def _split(p: Params, cfg: ModelConfig,
           tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """``tp`` where the planner split the time mix's heads over it (``p``
    holds this rank's heads of ``wr``/``wk``/``wv``/``wg``/``wo``/``w0``/
    ``wb``/``bonus_u``/``ln_x``), else None."""
    return tp if tp is not None and p["wr"].shape[1] < cfg.num_heads \
        else None


def time_mix_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     tp: Optional[TensorParallel] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), the WKV state after the prompt).

    With ``tp`` and the heads split over it, this rank's heads: the group
    norm per head as it is, ``wo``'s partial outputs summed over the
    group, and the WKV state of this rank's heads (the serving plan's
    cache splits it by heads).  The token-shift mixes ``mu`` and the decay
    LoRA's ``wa`` are whole on every rank; the activations they make enter
    this rank's heads through ``copy_to_tp``
    (:func:`time_mix_projections`), so a gradient taken of ``mu`` and
    ``wa`` comes from one full-width sum, as on one card."""
    tp = _split(p, cfg, tp)
    r, k, v, g, logw = time_mix_projections(p, x, None, cfg, tp)
    o, wkv = wkv_chunked(r, k, v, logw, p["bonus_u"])
    out = _time_mix_out(p, o.to(x.dtype), g)
    return (out if tp is None else reduce_from_tp(out, tp)), wkv


def time_mix_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x: (B, S, d) -> out (B, S, d): the reference's ``time_mix_train``,
    the prefill's output (the WKV state after the sequence goes unused),
    on this rank's heads where ``tp`` splits them."""
    return time_mix_prefill(p, x, cfg, tp)[0]


def time_mix_decode(p: Params, x: torch.Tensor, state: Params,
                    cfg: ModelConfig, tp: Optional[TensorParallel] = None
                    ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); the single-step recurrence.  Returns (out, the new
    {"wkv", "shift_t"}).  With ``tp`` and the heads split over it, this
    rank's heads, as in :func:`time_mix_prefill`: ``state["wkv"]`` holds
    them; ``shift_t``, the block's whole input, is whole on every rank."""
    tp = _split(p, cfg, tp)
    r, k, v, g, logw = time_mix_projections(p, x, state["shift_t"], cfg, tp)
    r32, k32, v32 = (t.float()[:, 0] for t in (r, k, v))
    w = torch.exp(logw.float())[:, 0]                         # (B, H, hd)
    u = p["bonus_u"].float()
    s_old = state["wkv"]                                      # (B, H, hd, hd)
    kv = k32[..., :, None] * v32[..., None, :]
    o = torch.einsum("bnh,bnhp->bnp", r32, s_old + u[None, :, :, None] * kv)
    s_new = s_old * w[..., None] + kv
    out = _time_mix_out(p, o[:, None].to(x.dtype), g)
    if tp is not None:
        out = reduce_from_tp(out, tp)
    return out, {"wkv": s_new, "shift_t": x}


def channel_mix(p: Params, x: torch.Tensor,
                x_prev: Optional[torch.Tensor] = None,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """With ``tp``, ``p`` holds this rank's ffn columns of ``ck``, rows of
    ``cv`` and output columns of ``cr`` (the model's ``channel_mix_train``
    gives it only then): the two mixes enter them through
    ``copy_to_tp``."""
    xx = token_shift(x, x_prev)
    mu = p["mu_c"]
    xk = _mix(x, xx, mu[0])
    xr = _mix(x, xx, mu[1])
    if tp is not None:
        xk, xr = copy_to_tp(xk, tp), copy_to_tp(xr, tp)
    kk = torch.square(F.relu(torch.matmul(xk, p["ck"])))
    rr = torch.sigmoid(torch.matmul(xr, p["cr"]).float())
    v = torch.matmul(kk, p["cv"])
    if tp is None:
        return rr.to(x.dtype) * v
    return gather_from_tp(rr.to(x.dtype), tp, -1) * reduce_from_tp(v, tp)


def channel_mix_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      tp: Optional[TensorParallel] = None,
                      x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The channel mix of a training forward or of a serving step under a
    plan (``x_prev``: the decode carry, as in :func:`channel_mix`).  With
    ``tp`` and the ffn split over it, this rank's part: ``kk @ cv`` is a
    partial sum of full width, summed over the group, and ``rr`` this
    rank's columns, all-gathered."""
    split = tp is not None and p["ck"].shape[1] < cfg.d_ff
    if split != (tp is not None and p["cr"].shape[1] < cfg.d_model):
        raise NotImplementedError(
            f"{cfg.name}: the channel mix splits its ffn ({cfg.d_ff}) and "
            f"its receptance columns ({cfg.d_model}) over the group "
            "together or neither")
    return channel_mix(p, x, x_prev, tp if split else None)
