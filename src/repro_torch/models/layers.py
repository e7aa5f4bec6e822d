"""Shared building blocks: norms, positions, MLPs, embeddings.

Counterpart of ``repro/models/layers.py``.  Plain functions on tensors
over plain parameter dictionaries, in the reference's layouts, so the
tests compare like with like.  ``rms_norm`` goes through the Hopper
RMSNorm kernel's autograd Function on CUDA tensors (its plain version,
differentiated by autograd, on CPU tensors); the large products stay
``torch.matmul`` (the reference leaves them to XLA).  Where no gradient
is taken (serving), ``rms_norm`` calls the kernel's wrapper directly and
builds no autograd node.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm

Params = Dict[str, Any]


class Spec(NamedTuple):
    """Parameter leaf spec: shape + init std (0 = zeros)."""
    shape: Tuple[int, ...]
    std: float = 0.02


class CacheSpec(NamedTuple):
    """Decode-state leaf spec: shape + dtype (the reference's
    ``jax.ShapeDtypeStruct``); materialized as zeros."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_from_specs(specs, generator: torch.Generator,
                    device: torch.device, dtype=torch.bfloat16) -> Params:
    """Materialize a parameter tree from a spec tree, leaves in sorted key
    order, by the reference's rules: zeros for std 0 (the ``(1+g)`` norm
    gains, biases), ones for an unstacked std-1 gain (a vector or a square
    matrix), else normal(0, std) drawn in fp32 and cast."""
    out = {}
    for key in sorted(specs):
        spec = specs[key]
        if isinstance(spec, dict):
            out[key] = init_from_specs(spec, generator, device, dtype)
        elif spec.std == 0.0:
            out[key] = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.std == 1.0 and (len(spec.shape) == 1 or (
                len(spec.shape) == 2 and spec.shape[0] == spec.shape[1])):
            out[key] = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            out[key] = (torch.randn(spec.shape, generator=generator,
                                    device=device, dtype=torch.float32)
                        * spec.std).to(dtype)
    return out


def param_count(specs) -> int:
    """Elements of every ``Spec`` leaf of a spec tree."""
    if isinstance(specs, Spec):
        return int(np.prod(specs.shape))
    return sum(param_count(v) for v in specs.values())


def param_bytes(specs, bytes_per_param: int = 2) -> int:
    return param_count(specs) * bytes_per_param


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), std=0.0)       # zero-init: (1+g) parameterization


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    if x.device.type != "cpu" and needs_grad(x, gain):
        return RMSNorm.apply(x, gain, eps)
    return rmsnorm(x, gain, eps)


def group_norm_heads(x: torch.Tensor, gain: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the last dim of (..., H, hd) (RWKV-6's
    ``ln_x``), fp32 statistics; plain ops (no Pallas counterpart)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gain.float()).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device: torch.device) -> torch.Tensor:
    """(seq_len, d_model) fp32 sin/cos positions, computed in float64 with
    numpy as the reference does and rounded once."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / np.power(10_000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def needs_grad(*ts: torch.Tensor) -> bool:
    """Will autograd record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    Half-split rotation computed in fp32."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    ang = positions[..., :, None].float() * rope_freqs(hd, theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp_specs(d_model: int, d_ff: int) -> Params:
    return {"wi_gate": Spec((d_model, d_ff)), "wi_up": Spec((d_model, d_ff)),
            "wo": Spec((d_ff, d_model))}


def gated_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p["wi_gate"])
    u = torch.matmul(x, p["wi_up"])
    return torch.matmul(F.silu(g) * u, p["wo"])


def embed_specs(vocab: int, d_model: int, tie: bool) -> Params:
    out = {"tok": Spec((vocab, d_model))}
    if not tie:
        out["head"] = Spec((d_model, vocab))
    return out


def embed(p: Params, tokens: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    x = p["tok"][tokens]
    if scale != 1.0:
        x = (x.float() * scale).to(x.dtype)
    return x


def unembed(p: Params, x: torch.Tensor,
            softcap: Optional[float] = 0.0) -> torch.Tensor:
    if "head" in p:
        logits = torch.matmul(x, p["head"])
    else:
        logits = torch.matmul(x, p["tok"].t())
    logits = logits.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood, fp32: logsumexp minus the
    label logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels.long()[..., None])[..., 0]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over valid positions (:func:`token_nll`).  logits fp32
    (..., V); labels (...) integer; mask (...) or None.  (The reference
    contracts with a one-hot to keep a vocab-sharded gather off its SPMD
    partitioner; a gather is exact and the port is not sharded.)"""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
