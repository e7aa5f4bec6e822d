"""Fused row RMSNorm on Hopper, written in Triton.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas kernel,
``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * (1 + gain)`` per row
with fp32 statistics, the ``(1+g)`` parameterization of the model's
norms (``models/layers.py::rms_norm``).

What bounds it on the H100: bytes.  A row of tinyllama-1.1b (d=2048,
bf16) is 4 KiB read and 4 KiB written for ~4 operations per element,
far below the card's ~295 operations per byte.  The design does the one
thing that matters for that: each program holds one whole row in
registers, so the row is read once and written once, with the reduction
and the scale in between (no second pass over device memory).  Ragged
widths are masked, so any ``D`` up to the block works.

:class:`RMSNorm` is the ``torch.autograd.Function`` the model calls on
CUDA tensors: its forward is the kernel, its backward
:func:`rmsnorm_bwd_ref` in plain tensor ops.  The reference has no Pallas
backward for the norm -- its training gradient is XLA's autodiff of jnp
``rms_norm`` -- so plain ops are the counterpart here, not a fallback.
"""

from __future__ import annotations

import torch

_KERNEL = None


def _kernel():
    """Compile-on-first-use: ``triton`` is imported only here, so the
    module imports on machines without it."""
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rmsnorm_row(x_ptr, g_ptr, o_ptr, stride_x, stride_o, d, eps,
                         BLOCK_D: tl.constexpr):
            row = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < d
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / d
            y = x * tl.rsqrt(var + eps)
            g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = y * (1.0 + g)
            tl.store(o_ptr + row * stride_o + cols,
                     y.to(o_ptr.dtype.element_ty), mask=mask)

        _KERNEL = (_rmsnorm_row, triton.next_power_of_2)
    return _KERNEL


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version, in the reference's order of operations."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gain.float())).to(x.dtype)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); gain: (D,) -> (..., D) in x's dtype.

    On a CPU tensor this is :func:`rmsnorm_ref`; on a CUDA tensor it
    launches the Triton kernel (one program per row) or raises."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gain, eps)
    if x.device.type != "cuda" or gain.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, gain on {gain.device}")
    d = x.shape[-1]
    if gain.shape != (d,):
        raise ValueError(f"rmsnorm: gain {tuple(gain.shape)} != ({d},)")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"rmsnorm: unsupported dtype {x.dtype}")
    if d > 16384:
        raise ValueError(f"rmsnorm: row width {d} exceeds one block")
    kernel, next_pow2 = _kernel()
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    gain = gain.contiguous()
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = next_pow2(d)
        kernel[(x2.shape[0],)](x2, gain, out, x2.stride(0), out.stride(0), d,
                               eps, BLOCK_D=block,
                               num_warps=min(max(block // 256, 1), 16))
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


def rmsnorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, gain: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of :func:`rmsnorm_ref` -> (dx in x's dtype, dgain in
    gain's dtype), in fp32.  With r = rsqrt(mean(x^2) + eps) and
    w = dy * (1 + g): dx = r * (w - x * r^2 * mean(w * x)) per row, and
    dg = sum over rows of dy * x * r (the ``(1+g)`` parameterization:
    d(1+g)/dg = 1)."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    dy32 = dy.float().reshape(-1, d)
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    w = dy32 * (1.0 + gain.float())
    dx = r * (w - x32 * r.square() * (w * x32).mean(-1, keepdim=True))
    dg = (dy32 * x32 * r).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dg.to(gain.dtype)


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x, gain) with a gradient: forward is the kernel
    (:func:`rmsnorm`), backward :func:`rmsnorm_bwd_ref`, recomputing the
    per-row statistic from the saved ``x``.

    ``RMSNorm.apply(x, gain, eps)``."""

    @staticmethod
    def forward(ctx, x, gain, eps=1e-6):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return rmsnorm(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dg = rmsnorm_bwd_ref(dy, x, gain, ctx.eps)
        return dx, dg, None
