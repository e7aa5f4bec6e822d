"""Fused row RMSNorm on Hopper, forward and backward, written in Triton.

The forward replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas
kernel, ``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * (1 + gain)``
per row with fp32 statistics, the ``(1+g)`` parameterization of the
model's norms (``models/layers.py::rms_norm``).  The backward replaces
what the reference's training takes for the norm's gradient, XLA's fused
autodiff of jnp ``rms_norm`` (``repro/models/layers.py:90``); the
reference has no Pallas backward.

What bounds both on the H100: bytes.  A row of tinyllama-1.1b (d=2048,
bf16) is 4 KiB read and 4 KiB written for ~4 operations per element,
far below the card's ~295 operations per byte; a decode step's 8 rows
are bound by the launch's fixed cost, which no design inside the kernel
removes (a CUDA graph or fusion with a neighbour does).  What the design
does about the bytes:

- Forward: each program holds one whole row in registers, padded to the
  next power of two, one 16-byte vector a thread, so the row is read
  once and written once with the reduction and the scale in between.
  Measured on the H100 against three alternatives -- several rows a
  program on a grid sized to the SMs, the row walked in power-of-two
  column chunks (read twice) or held as power-of-two pieces without
  masked lanes (2560 = 2048 + 512) -- it was as fast or faster at every
  shape class but one: a padded row's masked lanes move no bytes, and
  the gain, read by every program, comes from L2 (``PERF.md`` §6).
- Backward (``rmsnorm_bwd``): one pass per row reads x and dy once and
  writes dx in x's dtype, ``r = rsqrt(mean(x^2)+eps)``, ``w =
  dy*(1+g)``, ``dx = r*(w - x*r^2*mean(w*x))``, ``block_r`` rows at a
  time; each program takes ``rows_per_program`` rows (a grid of
  ``BWD_PROGRAMS_PER_SM`` programs an SM) and keeps its fp32 partial of
  ``dgain = sum_rows dy*x*r`` in registers, written once; a second small
  launch sums the partials in program order, so the result is
  deterministic without atomics.  It replaces ~22 launches of plain ops
  with fp32 temporaries.

:class:`RMSNorm` is the ``torch.autograd.Function`` the model calls on
tensors that need a gradient: its forward is :func:`rmsnorm`, its
backward :func:`rmsnorm_bwd`.  :func:`rmsnorm_ref` and
:func:`rmsnorm_bwd_ref` are the plain versions (the CPU path and the
yardsticks on the card); :func:`rmsnorm_bwd_mirror` repeats the
backward's per-program decomposition in plain PyTorch for the CPU tests.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE = 4096               # elements of a backward step (rows x columns)
BWD_PROGRAMS_PER_SM = 2   # the backward's grid: programs per SM
PARTIAL_ROWS = 64         # partials summed at once by the dgain launch
PARTIAL_COLS = 32
_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_KERNELS = None


def _kernels():
    """Compile-on-first-use: ``triton`` is imported only here, so the
    module imports on machines without it."""
    global _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_fwd_kernel(x_ptr, g_ptr, o_ptr, stride_x, stride_o, d,
                               eps, BLOCK_D: tl.constexpr):
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

        @triton.jit
        def rmsnorm_bwd_kernel(dy_ptr, x_ptr, g_ptr, dx_ptr, part_ptr, n_rows,
                               rows_per_program, stride_dy, stride_x,
                               stride_dx, d, eps, BLOCK_R: tl.constexpr,
                               BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            cmask = cols < d
            g1 = 1.0 + tl.load(g_ptr + cols, mask=cmask,
                               other=0.0).to(tl.float32)
            dg = tl.zeros([BLOCK_R, BLOCK_D], dtype=tl.float32)
            start = pid * rows_per_program
            end = tl.minimum(start + rows_per_program, n_rows)
            for r0 in range(start, end, BLOCK_R):
                rows = r0 + tl.arange(0, BLOCK_R)
                m = (rows < end)[:, None] & cmask[None, :]
                rows = rows.to(tl.int64)
                x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                            mask=m, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + rows[:, None] * stride_dy
                             + cols[None, :], mask=m,
                             other=0.0).to(tl.float32)
                r = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
                w = dy * g1[None, :]
                c = tl.sum(w * x, axis=1) / d
                dx = r[:, None] * (w - x * (r * r)[:, None] * c[:, None])
                tl.store(dx_ptr + rows[:, None] * stride_dx + cols[None, :],
                         dx.to(dx_ptr.dtype.element_ty), mask=m)
                dg += dy * x * r[:, None]
            tl.store(part_ptr + pid * d + cols, tl.sum(dg, axis=0),
                     mask=cmask)

        @triton.jit
        def rmsnorm_dgain_kernel(part_ptr, dg_ptr, n_parts, d,
                                 BLOCK_P: tl.constexpr,
                                 BLOCK_C: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < d
            acc = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
            for p0 in range(0, n_parts, BLOCK_P):
                parts = p0 + tl.arange(0, BLOCK_P)
                acc += tl.load(part_ptr + parts[:, None] * d + cols[None, :],
                               mask=(parts < n_parts)[:, None]
                               & cmask[None, :], other=0.0)
            tl.store(dg_ptr + cols,
                     tl.sum(acc, axis=0).to(dg_ptr.dtype.element_ty),
                     mask=cmask)

        _KERNELS = (rmsnorm_fwd_kernel, rmsnorm_bwd_kernel,
                    rmsnorm_dgain_kernel)
    return _KERNELS


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def bwd_blocks(rows: int, d: int, sms: int):
    """(block_r, block_d, rows_per_program) of the backward: the whole row
    in one block of the next power of two, ``block_r`` rows at a time
    within ``TILE`` elements, and a grid of about ``BWD_PROGRAMS_PER_SM``
    programs an SM, each taking ``rows_per_program`` rows (a multiple of
    ``block_r``)."""
    block_d = _pow2_ceil(d)
    block_r = max(1, min(4, TILE // block_d))
    per = -(-max(rows, 1) // (BWD_PROGRAMS_PER_SM * sms))
    return block_r, block_d, block_r * -(-per // block_r)


def _warps(tile: int) -> int:
    return min(max(_pow2_floor(tile // 512), 4), 16)


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    t = t.reshape(-1, d)
    return t if t.stride(-1) == 1 else t.contiguous()


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version, in the reference's order of operations."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gain.float())).to(x.dtype)


def _check(what: str, x: torch.Tensor, gain: torch.Tensor, *others):
    d = x.shape[-1]
    for t in (gain,) + others:
        if t.device != x.device:
            raise ValueError(f"{what}: x on {x.device}, an operand on "
                             f"{t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x on {x.device}")
    if gain.shape != (d,):
        raise ValueError(f"{what}: gain {tuple(gain.shape)} != ({d},)")
    if x.dtype not in _DTYPES or any(t.shape != x.shape or t.dtype != x.dtype
                                     for t in others):
        raise ValueError(f"{what}: x {x.dtype} {tuple(x.shape)}, others "
                         f"{[(t.dtype, tuple(t.shape)) for t in others]}; "
                         f"the kernel takes one of {_DTYPES} for all")
    if d > 16384:
        raise ValueError(f"{what}: row width {d} exceeds one block")


def rmsnorm(x: torch.Tensor, gain: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); gain: (D,) -> (..., D) in x's dtype.

    On a CPU tensor this is :func:`rmsnorm_ref`; on a CUDA tensor it
    launches the Triton kernel (one program per row) or raises."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gain, eps)
    _check("rmsnorm", x, gain)
    d = x.shape[-1]
    fwd = _kernels()[0]
    x2 = _rows(x, d)
    gain = gain.contiguous()
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = _pow2_ceil(d)
        fwd[(x2.shape[0],)](x2, gain, out, x2.stride(0), out.stride(0), d,
                            eps, BLOCK_D=block,
                            num_warps=min(max(block // 256, 1), 16))
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


def _bwd_terms(dy, x, gain, eps):
    """(dx, dy * x * r) of the backward in fp32, rows flattened."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    dy32 = dy.float().reshape(-1, d)
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    w = dy32 * (1.0 + gain.float())
    dx = r * (w - x32 * r.square() * (w * x32).mean(-1, keepdim=True))
    return dx, dy32 * x32 * r


def rmsnorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, gain: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of :func:`rmsnorm_ref` -> (dx in x's dtype, dgain in
    gain's dtype), in fp32.  With r = rsqrt(mean(x^2) + eps) and
    w = dy * (1 + g): dx = r * (w - x * r^2 * mean(w * x)) per row, and
    dg = sum over rows of dy * x * r (the ``(1+g)`` parameterization:
    d(1+g)/dg = 1)."""
    dx, terms = _bwd_terms(dy, x, gain, eps)
    return dx.reshape(x.shape).to(x.dtype), terms.sum(0).to(gain.dtype)


def rmsnorm_bwd_mirror(dy: torch.Tensor, x: torch.Tensor, gain: torch.Tensor,
                       eps: float, rows_per_program: int):
    """The backward kernel's decomposition in plain PyTorch, in fp32:
    dx per row as :func:`rmsnorm_bwd_ref`, and dgain as the kernel forms
    it -- each run of ``rows_per_program`` rows (one program) sums its
    dy * x * r into a partial, and the partials are summed in program
    order.  Returns (dx in x's dtype, dgain in gain's dtype)."""
    dx, terms = _bwd_terms(dy, x, gain, eps)
    dg = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    for part in terms.split(rows_per_program):
        dg = dg + part.sum(0)
    return dx.reshape(x.shape).to(x.dtype), dg.to(gain.dtype)


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, gain: torch.Tensor,
                eps: float = 1e-6):
    """Gradients of :func:`rmsnorm` at ``x`` for the output gradient
    ``dy`` -> (dx in x's dtype, dgain in gain's dtype).

    On CPU tensors this is :func:`rmsnorm_bwd_ref`; on CUDA tensors it
    launches the two Triton kernels (the rows with the dgain partials, then
    their sum; one call is one launch of the count) or raises."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(dy, x, gain, eps)
    _check("rmsnorm_bwd", x, gain, dy)
    d = x.shape[-1]
    _, bwd, dgain = _kernels()
    x2, dy2 = _rows(x, d), _rows(dy, d)
    gain = gain.contiguous()
    rows = x2.shape[0]
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dg = torch.empty((d,), dtype=gain.dtype, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), dg.zero_()
    block_r, block_d, per = bwd_blocks(rows, d,
                                       _build.sm_count(x.device.index))
    programs = -(-rows // per)
    part = torch.empty((programs, d), dtype=torch.float32, device=x.device)
    bwd[(programs,)](dy2, x2, gain, dx, part, rows, per, dy2.stride(0),
                     x2.stride(0), dx.stride(0), d, eps, BLOCK_R=block_r,
                     BLOCK_D=block_d, num_warps=_warps(block_r * block_d))
    dgain[(-(-d // PARTIAL_COLS),)](part, dg, programs, d,
                                    BLOCK_P=PARTIAL_ROWS,
                                    BLOCK_C=PARTIAL_COLS, num_warps=4)
    rmsnorm_bwd.launches += 1
    return dx.reshape(x.shape), dg


rmsnorm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x, gain) with a gradient: forward :func:`rmsnorm`,
    backward :func:`rmsnorm_bwd`, recomputing the per-row statistic from
    the saved ``x``.

    ``RMSNorm.apply(x, gain, eps)``."""

    @staticmethod
    def forward(ctx, x, gain, eps=1e-6):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return rmsnorm(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(dy, x, gain, ctx.eps)
        return dx, dg, None
