"""Mamba-2 SSD scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/ssd_scan.py``.  The kernel
(``csrc/ssd_scan.cu``) replaces the Pallas ``ssd_scan``; its source note
says what bounds it on the H100 and how the design answers.  The dense
serving path reaches it through ``models/mamba2.ssd_chunked`` in every
Mamba-2 prefill.

The function, from a zero state, per head::

    h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T        y_t = h_t C_t

:func:`ssd_scan_ref` is the plain PyTorch version: the chunked form of the
reference's ``mamba2.ssd_chunked`` (an intra-chunk decay-masked
``C B^T`` product plus the carried state), the port's CPU path and the
yardstick the kernel is held against on the card.  Every exponent it
takes is a decay between two positions of the chunk, ``csum[t] -
csum[s]`` with ``s <= t``, and so never above 0: it needs none of the
reference's clamps.  A ragged tail is zero-padded (dt = 0 and a = 0 leave
the state as it is), so the final state is the state after exactly S
tokens.

:func:`ssd_scan_mirror` repeats the bf16 kernel's decomposition in plain
PyTorch -- every chunk of :data:`KERNEL_CHUNK` tokens at once (its output
and its own state), then the states passed between chunks in order, then
each chunk's output from the state before it -- so that the CPU tests can
hold that decomposition against the reference's per-step oracle.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = {"ssd_scan": (_P,) * 9 + (_I,) * 5 + (_P, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# chunk length of the plain version (exact at any chunk)
CHUNK = 128
# the bf16 kernel's chunk (kQ in csrc/chunked_scan.cuh) and its widest
# max(P, N)
KERNEL_CHUNK = 64
KERNEL_MAX_DIM = 128


def ssd_scan_ref(x, dt, a, b, c):
    """x: (B, H, S, P); dt, a: (B, H, S); b, c: (B, S, N) -> (y (B, H, S, P)
    fp32, final state (B, H, P, N) fp32), in chunks of :data:`CHUNK`
    tokens."""
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    cs = max(min(CHUNK, s), 1)
    pad = (-s) % cs
    x32, dt32, a32 = x.float(), dt.float(), a.float()
    b32, c32 = b.float(), c.float()
    if pad:
        x32 = F.pad(x32, (0, 0, 0, pad))
        dt32, a32 = F.pad(dt32, (0, pad)), F.pad(a32, (0, pad))
        b32, c32 = F.pad(b32, (0, 0, 0, pad)), F.pad(c32, (0, 0, 0, pad))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    causal = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s + pad, cs):
        xc = x32[:, :, t0:t0 + cs]                        # (B, H, C, P)
        dtc, ac = dt32[:, :, t0:t0 + cs], a32[:, :, t0:t0 + cs]
        bc, cc = b32[:, t0:t0 + cs], c32[:, t0:t0 + cs]   # (B, C, N)
        csum = ac.cumsum(-1)                              # (B, H, C)
        total = csum[..., -1:]
        # carried state, decayed from the chunk start through token t
        y = torch.einsum("bcn,bhpn->bhcp", cc, state) * csum.exp()[..., None]
        # within the chunk: exp(csum[t] - csum[s]) dt_s (C_t . B_s) x_s
        att = torch.einsum("bcn,bsn->bcs", cc, bc)        # (B, C, C)
        diff = csum[..., :, None] - csum[..., None, :]    # (B, H, C, C)
        pair = torch.where(causal, diff, float("-inf")).exp()
        y = y + torch.einsum("bhcs,bhsp->bhcp", att[:, None] * pair,
                             xc * dtc[..., None])
        ys.append(y)
        kdec = (dtc * (total - csum).exp())[..., None] * bc[:, None]
        state = (state * total.exp()[..., None]
                 + torch.einsum("bhcn,bhcp->bhpn", kdec, xc))
    return torch.cat(ys, dim=2)[:, :, :s], state


def ssd_scan_mirror(x, dt, a, b, c, chunk=KERNEL_CHUNK):
    """The bf16 kernel's decomposition, in plain PyTorch and fp32; the
    arguments and results of :func:`ssd_scan_ref`.  Pass 1 takes every
    chunk at once: its inclusive log-decay sum ``csum``, ``W = (C B^T)
    exp(csum_t - csum_s) dt_s`` for ``s <= t``, ``y = W X`` and the
    chunk's own state ``X^T (B dt exp(total - csum))``.  Pass 2 carries
    the states across the chunks in order.  Pass 3 adds ``exp(csum_t) (C
    h_prev^T)[t]``.  Every exponent is at most 0."""
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    nc = max(-(-s // chunk), 1)
    pad = nc * chunk - s
    x32, dt32, a32 = (F.pad(t.float(), (0, 0, 0, pad)) if t.dim() == 4
                      else F.pad(t.float(), (0, pad)) for t in (x, dt, a))
    b32, c32 = (F.pad(t.float(), (0, 0, 0, pad)) for t in (b, c))
    xc = x32.unflatten(2, (nc, chunk))                    # (B, H, nc, Q, P)
    dtc, ac = (t.unflatten(2, (nc, chunk)) for t in (dt32, a32))
    bc, cc = (t.unflatten(1, (nc, chunk)) for t in (b32, c32))  # (B,nc,Q,N)
    csum = ac.cumsum(-1)                                  # (B, H, nc, Q)
    total = csum[..., -1:]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    diff = csum[..., :, None] - csum[..., None, :]
    decay = torch.where(causal, torch.where(causal, diff, 0.0).exp(), 0.0)
    w = (torch.einsum("bctn,bcsn->bcts", cc, bc)[:, None] * decay
         * dtc[..., None, :])
    y = torch.einsum("bhcts,bhcsp->bhctp", w, xc)
    bd = bc[:, None] * (dtc * (total - csum).exp())[..., None]
    own = torch.einsum("bhcsp,bhcsn->bhcpn", xc, bd)      # (B, H, nc, P, N)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * total[:, :, i, :, None].exp() + own[:, :, i]
    y = y + csum.exp()[..., None] * torch.einsum(
        "bctn,bhcpn->bhctp", cc, torch.stack(prev, dim=2))
    return y.flatten(2, 3)[:, :, :s], state


def ssd_scan(x, dt, a, b, c):
    """x: (B, H, S, P) bf16 or fp32; dt, a: (B, H, S) fp32; b, c: (B, S, N)
    in x's dtype -- any strides with a contiguous last dim for x, b and c.
    Returns (y (B, H, S, P) fp32, stored in (B, S, H, P) memory order, the
    model's layout; final state (B, H, P, N) fp32), from a zero state.

    On CPU tensors this is :func:`ssd_scan_ref`.  On CUDA tensors it
    launches the kernel, or raises: bf16 takes the chunked form on the
    tensor cores (three CUDA launches, counted as one; max(P, N) at most
    :data:`KERNEL_MAX_DIM`), fp32 steps the recurrence token by token."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b, c)
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("ssd_scan: tensors on different devices")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype \
            or dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dtypes x={x.dtype} b={b.dtype} "
                         f"c={c.dtype} dt={dt.dtype} a={a.dtype}; x, b, c "
                         "bfloat16 or float32 alike, dt and a float32")
    if dt.shape != (bsz, h, s) or a.shape != (bsz, h, s) \
            or b.shape != (bsz, s, n) or c.shape != (bsz, s, n) or n > 256 \
            or (x.dtype == torch.bfloat16 and max(p, n) > KERNEL_MAX_DIM):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" a {tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} (state dim at most 256; head "
                         f"and state dims at most {KERNEL_MAX_DIM} in bf16)")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty((bsz, s, h, p), dtype=torch.float32,
                    device=x.device).transpose(1, 2)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if s == 0:
        return y, state.zero_()
    # the bf16 kernel's scratch: each chunk's state and log-decay
    nc = -(-s // KERNEL_CHUNK) if x.dtype == torch.bfloat16 else 0
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    totals = torch.empty((bsz, h, nc), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 16)(
        *x.stride()[:3], *dt.stride(), *a.stride(), *b.stride()[:2],
        *c.stride()[:2], *y.stride()[:3])
    lib = _build.library("ssd_scan", _SIGNATURE)
    code = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
        totals.data_ptr(), bsz, h, s, p, n,
        ctypes.addressof(strides), _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(code, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
