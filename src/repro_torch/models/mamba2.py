"""Mamba-2 block (SSD: state-space duality) for training and serving.

Counterpart of ``repro/models/mamba2.py``.  Selective SSM with a scalar
decay per head::

    h_t = exp(a_t) h_{t-1} + dt_t * B_t x_t^T      (h: (H, P, N))
    y_t = C_t h_t + D x_t

with a_t = -exp(A_log) * dt_t, dt_t = softplus(dt_raw + dt_bias).
Training and prefill run the scan over the whole sequence from a zero
state through the SSD kernel (``ssd_chunked`` -> ``kernels.ssd_scan``;
its plain chunked version on CPU tensors), and through its autograd
Function ``SSDScan`` where a gradient is taken.  Decode is the
single-step recurrence in plain ops: a one-token update has no Pallas
counterpart.  The conv state is bf16 and
the SSM state fp32, as in the reference.  Training, prefill and decode
under tensor parallelism (``tp``) run this rank's heads; the inner gated
norm, whose rows are then split over the group, takes the whole row's
mean square into the RMSNorm kernel from outside (its partial sums of
squares summed over the group).  A serving plan of a mesh splits the SSM
state by heads and keeps the conv state whole on every rank, so serving
all-gathers the rank's block of the conv state's x columns over the
group after each prefill and decode step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan
from repro_torch.models.layers import (CacheSpec, Spec, needs_grad,
                                      rms_norm)
from repro_torch.sharding.collectives import (TensorParallel, all_reduce,
                                              copy_to_tp, gather_from_tp,
                                              reduce_from_tp)

Params = Dict[str, Any]


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.head_dim, ssm.state_dim


def mamba2_specs(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    d_inner, h, _, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n  # x, B, C share the depthwise conv
    return {
        "w_in_z": Spec((d, d_inner), ("embed", "ssm_inner")),
        "w_in_x": Spec((d, d_inner), ("embed", "ssm_inner")),
        "w_in_b": Spec((d, n), ("embed", "ssm_state")),
        "w_in_c": Spec((d, n), ("embed", "ssm_state")),
        "w_in_dt": Spec((d, h), ("embed", "ssm_heads")),
        "conv_w": Spec((cfg.ssm.conv_width, conv_dim),
                       ("conv_w", "ssm_conv")),
        "conv_b": Spec((conv_dim,), ("ssm_conv",), std=0.0),
        "a_log": Spec((h,), ("ssm_heads",), std=0.02),
        "dt_bias": Spec((h,), ("ssm_heads",), std=0.02),
        "d_skip": Spec((h,), ("ssm_heads",), std=0.02),
        "norm": Spec((d_inner,), ("ssm_inner",), std=0.0),
        "w_out": Spec((d_inner, d), ("ssm_inner", "embed")),
    }


def mamba_state_specs(cfg: ModelConfig, batch: int) -> Params:
    d_inner, h, p_dim, n = mamba_dims(cfg)
    conv_dim = d_inner + 2 * n
    k = cfg.ssm.conv_width
    return {"ssm": CacheSpec((batch, h, p_dim, n), torch.float32),
            "conv": CacheSpec((batch, k - 1, conv_dim), torch.bfloat16)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  Returns (y,
    new_conv_state (B, K-1, C)), in x's dtype as the reference rounds."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + x.shape[1]] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return F.silu(y + b), new_state


def _projections(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: Optional[torch.Tensor]):
    """(z, x heads' channels, B, C, dt, the new conv state); the widths are
    ``p``'s own (under TP this rank's channels and heads)."""
    d_inner, n = p["w_in_x"].shape[1], p["w_in_b"].shape[1]
    z = torch.matmul(x, p["w_in_z"])
    xbc = torch.cat([torch.matmul(x, p["w_in_x"]),
                     torch.matmul(x, p["w_in_b"]),
                     torch.matmul(x, p["w_in_c"])], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xh = xbc[..., :d_inner]
    b_in = xbc[..., d_inner:d_inner + n]
    c_in = xbc[..., d_inner + n:]
    dt = F.softplus(torch.matmul(x, p["w_in_dt"]).float()
                    + p["dt_bias"].float())
    return z, xh, b_in, c_in, dt, new_conv


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan from a zero state.  xh: (B, S, H, P); dt: (B, S, H)
    fp32; b_in, c_in: (B, S, N).  Returns (y (B, S, H, P) fp32, final
    state (B, H, P, N) fp32).  The kernel reads the model's layouts
    through strides; ``SSDScan`` carries the gradient where one is
    taken."""
    a = -torch.exp(a_log.float())[None, None, :] * dt          # (B, S, H)
    ins = (xh.transpose(1, 2), dt.transpose(1, 2), a.transpose(1, 2), b_in,
           c_in)
    scan = SSDScan.apply if needs_grad(*ins) else ssd_scan
    y, state = scan(*ins)
    return y.transpose(1, 2), state


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, tp: Optional[TensorParallel] = None
              ) -> torch.Tensor:
    """The inner (1+g) RMSNorm of y * silu(z), then the out projection.
    With ``tp``, ``y`` and ``z`` are this rank's channels: the norm's mean
    square is summed over the group (K3's split rows:
    ``kernels.rmsnorm.rmsnorm``) and the row-parallel projection's
    partial outputs too."""
    split = None if tp is None else (
        mamba_dims(cfg)[0], lambda t: all_reduce(t, tp.group))
    v = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps, split)
    out = torch.matmul(v, p["w_out"])
    return out if tp is None else reduce_from_tp(out, tp)


def _ssd_block(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, p's channels) in x's dtype, z, the SSM
    state after the sequence, the conv state)."""
    bsz, s, _ = x.shape
    p_dim = cfg.ssm.head_dim
    z, xh, b_in, c_in, dt, conv_state = _projections(p, x, cfg, None)
    xh_r = xh.unflatten(-1, (-1, p_dim))
    y, ssm = ssd_chunked(xh_r, dt, p["a_log"], b_in, c_in)
    y = y + xh_r.float() * p["d_skip"].float()[:, None]
    return y.reshape(bsz, s, -1).to(x.dtype), z, ssm, conv_state


def _rank_params(p: Params, cfg: ModelConfig,
                 tp: Optional[TensorParallel]) -> Optional[Params]:
    """``p`` for this rank's heads where the planner split them over
    ``tp`` (``p`` holds this rank's columns of ``w_in_z``/``w_in_x``/
    ``w_in_dt``/``norm``, heads of ``a_log``/``dt_bias``/``d_skip`` and
    rows of ``w_out``), else None.  ``w_in_b``, ``w_in_c``, ``conv_w`` and
    ``conv_b`` are whole on every rank: B and C feed every head, and the
    conv's x columns are disjoint between ranks, so the rank keeps its
    block of x's columns and all of B's and C's.  Each whole weight
    enters through ``copy_to_tp``, so that a gradient taken of it is
    summed over the group."""
    d_inner = mamba_dims(cfg)[0]
    dl = p["w_in_x"].shape[1]
    if tp is None or dl == d_inner:
        return None
    own = slice(tp.rank * dl, (tp.rank + 1) * dl)
    conv_w, conv_b = (copy_to_tp(p[k], tp) for k in ("conv_w", "conv_b"))
    return dict(p, w_in_b=copy_to_tp(p["w_in_b"], tp),
                w_in_c=copy_to_tp(p["w_in_c"], tp),
                conv_w=torch.cat([conv_w[:, own], conv_w[:, d_inner:]], 1),
                conv_b=torch.cat([conv_b[own], conv_b[d_inner:]]))


def _whole_conv(conv: torch.Tensor, dl: int,
                tp: TensorParallel) -> torch.Tensor:
    """The conv state (B, K-1, d_inner + 2N) whole, as every rank stores
    it (``cache_specs_tree`` splits it over the batch only), from this
    rank's (B, K-1, dl + 2N): its block of x's columns all-gathered over
    the group in rank order, then B's and C's, which every rank holds."""
    return torch.cat([gather_from_tp(conv[..., :dl], tp, -1),
                      conv[..., dl:]], -1)


def mamba2_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   tp: Optional[TensorParallel] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> (out (B, S, d), {"ssm", "conv"} after the prompt).
    With ``tp`` and the heads split over it (:func:`_rank_params`), this
    rank's heads: the ``ssm`` state holds them, as the serving plan's
    cache splits it by heads, and the ``conv`` state is whole
    (:func:`_whole_conv`)."""
    local = _rank_params(p, cfg, tp)
    if local is None:
        y, z, ssm, conv_state = _ssd_block(p, x, cfg)
        return _gate_out(p, y, z, cfg), {"ssm": ssm, "conv": conv_state}
    y, z, ssm, conv_state = _ssd_block(local, x, cfg)
    conv_state = _whole_conv(conv_state, local["w_in_x"].shape[1], tp)
    return _gate_out(local, y, z, cfg, tp), {"ssm": ssm, "conv": conv_state}


def mamba2_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x: (B, S, d) -> out (B, S, d): the reference's ``mamba2_train``, the
    prefill's output (the states after the sequence go unused).

    With ``tp`` and the heads split over it, this rank's heads
    (:func:`_rank_params`): the conv runs over its block of x's channels
    and the whole B and C channels; the input enters through
    ``copy_to_tp``, so its gradient is summed over the group."""
    local = _rank_params(p, cfg, tp)
    if local is None:
        return mamba2_prefill(p, x, cfg)[0]
    y, z, _, _ = _ssd_block(local, copy_to_tp(x, tp), cfg)
    return _gate_out(local, y, z, cfg, tp)


def mamba2_decode(p: Params, x: torch.Tensor, state: Params,
                  cfg: ModelConfig, tp: Optional[TensorParallel] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); the single-step recurrence.  Returns (out, the new
    {"ssm", "conv"}).  With ``tp`` and the heads split over it, this
    rank's heads: ``state["ssm"]`` holds them, ``state["conv"]`` is whole
    and the rank reads its columns of it (its block of x's, all of B's
    and C's); the new conv state is whole again (:func:`_whole_conv`)."""
    local = _rank_params(p, cfg, tp)
    conv = state["conv"]
    if local is not None:
        dl = local["w_in_x"].shape[1]
        own = slice(tp.rank * dl, (tp.rank + 1) * dl)
        conv = torch.cat([conv[..., own], conv[..., mamba_dims(cfg)[0]:]],
                         -1)
        p = local
    bsz = x.shape[0]
    d_inner, p_dim = p["w_in_x"].shape[1], cfg.ssm.head_dim
    h = d_inner // p_dim
    z, xh, b_in, c_in, dt, new_conv = _projections(p, x, cfg, conv)
    xh32 = xh.reshape(bsz, h, p_dim).float()
    dt1 = dt[:, 0]                                             # (B, H)
    a = torch.exp(-torch.exp(p["a_log"].float())[None] * dt1)  # (B, H)
    b32 = b_in[:, 0].float()                                   # (B, N)
    c32 = c_in[:, 0].float()
    upd = dt1[..., None, None] * xh32[..., None] * b32[:, None, None, :]
    new_ssm = state["ssm"] * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_ssm, c32)
    y = y + xh32 * p["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    if local is not None:
        new_conv = _whole_conv(new_conv, d_inner, tp)
    return _gate_out(p, y, z, cfg, tp if local is not None else None), \
        {"ssm": new_ssm, "conv": new_conv}
