"""Mamba-2 block (SSD: state-space duality) for serving.

Counterpart of ``repro/models/mamba2.py``.  Selective SSM with a scalar
decay per head::

    h_t = exp(a_t) h_{t-1} + dt_t * B_t x_t^T      (h: (H, P, N))
    y_t = C_t h_t + D x_t

with a_t = -exp(A_log) * dt_t, dt_t = softplus(dt_raw + dt_bias).  Prefill
runs the scan over the whole prompt from a zero state through the SSD
kernel (``ssd_chunked`` -> ``kernels.ssd_scan``; its plain chunked version
on CPU tensors).  Decode is the single-step recurrence in plain ops: a
one-token update has no Pallas counterpart.  The conv state is bf16 and
the SSM state fp32, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import CacheSpec, Spec, rms_norm

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
        "w_in_z": Spec((d, d_inner)),
        "w_in_x": Spec((d, d_inner)),
        "w_in_b": Spec((d, n)),
        "w_in_c": Spec((d, n)),
        "w_in_dt": Spec((d, h)),
        "conv_w": Spec((cfg.ssm.conv_width, conv_dim)),
        "conv_b": Spec((conv_dim,), std=0.0),
        "a_log": Spec((h,), std=0.02),
        "dt_bias": Spec((h,), std=0.02),
        "d_skip": Spec((h,), std=0.02),
        "norm": Spec((d_inner,), std=0.0),
        "w_out": Spec((d_inner, d)),
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
    d_inner, _, _, n = mamba_dims(cfg)
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
    through strides."""
    a = -torch.exp(a_log.float())[None, None, :] * dt          # (B, S, H)
    y, state = ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2),
                        a.transpose(1, 2), b_in, c_in)
    return y.transpose(1, 2), state


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The inner (1+g) RMSNorm of y * silu(z), then the out projection."""
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"])


def mamba2_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Params]:
    """x: (B, S, d) -> (out (B, S, d), {"ssm", "conv"} after the prompt)."""
    bsz, s, _ = x.shape
    d_inner, h, p_dim, _ = mamba_dims(cfg)
    z, xh, b_in, c_in, dt, conv_state = _projections(p, x, cfg, None)
    xh_r = xh.unflatten(-1, (h, p_dim))
    y, ssm = ssd_chunked(xh_r, dt, p["a_log"], b_in, c_in)
    y = y + xh_r.float() * p["d_skip"].float()[:, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    return _gate_out(p, y, z, cfg), {"ssm": ssm, "conv": conv_state}


def mamba2_decode(p: Params, x: torch.Tensor, state: Params,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); the single-step recurrence.  Returns (out, the new
    {"ssm", "conv"})."""
    bsz = x.shape[0]
    d_inner, h, p_dim, _ = mamba_dims(cfg)
    z, xh, b_in, c_in, dt, new_conv = _projections(p, x, cfg, state["conv"])
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
    return _gate_out(p, y, z, cfg), {"ssm": new_ssm, "conv": new_conv}
