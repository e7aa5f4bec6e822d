"""Mamba-2 SSD scan: the CUDA kernel's wrapper, its plain version, and the
autograd Function that gives it a gradient.

Counterpart of ``repro/kernels/ssd_scan.py``.  The kernel
(``csrc/ssd_scan.cu``) replaces the Pallas ``ssd_scan``; its source note
says what bounds it on the H100 and how the design answers.  The dense
serving path reaches it through ``models/mamba2.ssd_chunked`` in every
Mamba-2 prefill, and training through :class:`SSDScan`, whose backward
(:func:`ssd_scan_bwd`) is PyTorch ops from the chunk-start states the
kernel keeps: the reference differentiates its jnp scan with XLA's
autodiff and has no backward kernel.

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


def _masked_exp(keep, x):
    """exp(x) where ``keep``, else 0; x is zeroed before ``exp`` where not
    kept, so neither the value nor its gradient overflows there."""
    return torch.where(keep, torch.where(keep, x, 0.0).exp(), 0.0)


def _ssd_chunks(x, dt, a, b, c, h0):
    """The SSD over a group of G chunks, each from its own start state,
    in fp32.  x: (B, H, G, Q, P); dt, a: (B, H, G, Q); b, c: (B, G, Q, N);
    h0: (B, H, G, P, N) -> (y (B, H, G, Q, P), each chunk's end state
    (B, H, G, P, N)).  ``csum`` is the inclusive log-decay sum in each
    chunk; every exponent taken is ``csum[t] - csum[s]`` for ``s <= t``,
    ``total - csum[s]``, ``csum[t]`` or ``total``, so never above 0 (the
    masked pairs' exponents are zeroed before ``exp``, so their gradients
    stay finite too)."""
    q = x.shape[-2]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    csum = a.cumsum(-1)                                   # (B, H, G, Q)
    total = csum[..., -1:]
    # within the chunk: exp(csum[t] - csum[s]) dt_s (C_t . B_s) x_s
    diff = csum[..., :, None] - csum[..., None, :]        # (B, H, G, Q, Q)
    w = (torch.einsum("bgtn,bgsn->bgts", c, b)[:, None]
         * _masked_exp(causal, diff) * dt[..., None, :])
    # plus the start state, decayed from the chunk start through token t
    y = (torch.einsum("bhgts,bhgsp->bhgtp", w, x) + csum.exp()[..., None]
         * torch.einsum("bgtn,bhgpn->bhgtp", c, h0))
    bd = b[:, None] * (dt * (total - csum).exp())[..., None]
    h1 = (h0 * total.exp()[..., None]
          + torch.einsum("bhgsp,bhgsn->bhgpn", x, bd))
    return y, h1


def _pad_chunks(t, seq_dim, nc, q):
    """``t`` in fp32, zero-padded along ``seq_dim`` to ``nc * q`` and split
    there into (nc, q)."""
    t = t.float()
    pad = nc * q - t.shape[seq_dim]
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 1 - seq_dim) + (0, pad))
    return t.unflatten(seq_dim, (nc, q))


def ssd_scan_ref(x, dt, a, b, c):
    """x: (B, H, S, P); dt, a: (B, H, S); b, c: (B, S, N) -> (y (B, H, S, P)
    fp32, final state (B, H, P, N) fp32), in chunks of :data:`CHUNK`
    tokens."""
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    cs = max(min(CHUNK, s), 1)
    nc = max(-(-s // cs), 1)
    xs, dts, as_ = (_pad_chunks(t, 2, nc, cs) for t in (x, dt, a))
    bs, cs_ = (_pad_chunks(t, 1, nc, cs) for t in (b, c))
    state = torch.zeros((bsz, h, 1, p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for i in range(nc):
        one = slice(i, i + 1)
        y, state = _ssd_chunks(xs[:, :, one], dts[:, :, one], as_[:, :, one],
                               bs[:, one], cs_[:, one], state)
        ys.append(y)
    return torch.cat(ys, dim=2).flatten(2, 3)[:, :, :s], state[:, :, 0]


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
    w = (torch.einsum("bctn,bcsn->bcts", cc, bc)[:, None]
         * _masked_exp(causal, diff) * dtc[..., None, :])
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


def ssd_scan(x, dt, a, b, c, *, chunk_states: bool = False):
    """x: (B, H, S, P) bf16 or fp32; dt, a: (B, H, S) fp32; b, c: (B, S, N)
    in x's dtype -- any strides with a contiguous last dim for x, b and c.
    Returns (y (B, H, S, P) fp32, stored in (B, S, H, P) memory order, the
    model's layout; final state (B, H, P, N) fp32), from a zero state.
    With ``chunk_states`` a third result: the state before each chunk of
    :data:`KERNEL_CHUNK` tokens, (B, H, ceil(S / 64), P, N) fp32, which
    the bf16 kernel leaves in its ``states`` buffer after its second
    launch; None where the route keeps none (CPU tensors, fp32).

    On CPU tensors this is :func:`ssd_scan_ref`.  On CUDA tensors it
    launches the kernel, or raises: bf16 takes the chunked form on the
    tensor cores (three CUDA launches, counted as one; max(P, N) at most
    :data:`KERNEL_MAX_DIM`), fp32 steps the recurrence token by token."""
    if x.device.type == "cpu":
        out = ssd_scan_ref(x, dt, a, b, c)
        return out + (None,) if chunk_states else out
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
    # the bf16 kernel's buffers: each chunk's own state, which its second
    # launch replaces by the state before the chunk, and log-decay
    nc = -(-s // KERNEL_CHUNK) if x.dtype == torch.bfloat16 else 0
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    if s == 0:
        state.zero_()
    else:
        totals = torch.empty((bsz, h, nc), dtype=torch.float32,
                             device=x.device)
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
    if not chunk_states:
        return y, state
    return y, state, (states if nc else None)


ssd_scan.launches = 0


# the backward's chunk: the bf16 kernel's, whose chunk-start states it
# takes as they are
BWD_CHUNK = KERNEL_CHUNK
# fp32 elements of one pair-sized (chunk x chunk) tensor that a group of
# chunks may hold in the backward (512 MiB): it bounds the group
BWD_PAIR_ELEMENTS = 1 << 27


def ssd_scan_bwd(x, dt, a, b, c, states, dy, dstate):
    """The gradient of :func:`ssd_scan` -> (dx, ddt, da, db, dc), each in
    its input's dtype and shape, from the inputs, the states before each
    chunk of :data:`BWD_CHUNK` tokens (``states``, the kernel's; None:
    computed here), dy (B, H, S, P) and the final state's gradient
    ``dstate`` (B, H, P, N) (either may be None: zero).

    PyTorch ops, the counterpart of the reference's autodiff of
    ``lax.scan(jax.remat(per_chunk))``: every chunk's end-state gradient
    first (the reverse of the forward's pass over the states, ``dh_prev =
    exp(total) dh + sum_t exp(csum_t) dy_t^T C_t``, summed in closed form
    over the chunks), then each group of chunks
    recomputed from its start states (:func:`_ssd_chunks`) and
    differentiated by autograd with those gradients.  A group holds at
    most :data:`BWD_PAIR_ELEMENTS` pair elements; nothing holds the whole
    sequence's pairs.  Exact across chunks and ragged tails (zero
    padding adds nothing and decays nothing), at any decay."""
    bsz, h, s, _ = x.shape
    ins = (x, dt, a, b, c)
    if s == 0:
        return tuple(torch.zeros_like(t) for t in ins)
    q = BWD_CHUNK
    nc = -(-s // q)
    xs, dts, as_ = (_pad_chunks(t, 2, nc, q) for t in (x, dt, a))
    bs, cs_ = (_pad_chunks(t, 1, nc, q) for t in (b, c))
    dys = (_pad_chunks(dy, 2, nc, q) if dy is not None
           else xs.new_zeros(xs.shape))
    csum = as_.cumsum(-1)
    # the decay between two chunk boundaries: acc[c] sums the log-decays
    # of the chunks before c, so exp(acc[j] - acc[c]) (j >= c) decays a
    # state from boundary c to boundary j
    acc = F.pad(csum[..., -1].cumsum(-1), (1, 0))         # (B, H, nc + 1)
    later = torch.ones(nc, nc, dtype=torch.bool, device=x.device).triu(1)
    if states is None:            # h before chunk c: own states j < c
        own = torch.einsum("bhcsp,bhcsn->bhcpn", xs, bs[:, None] * (
            dts * (csum[..., -1:] - csum).exp())[..., None])
        states = torch.einsum(
            "bhcj,bhjpn->bhcpn", _masked_exp(later.T, acc[..., :nc, None]
                                             - acc[..., None, 1:]), own)
        del own
    # the gradient of each chunk's end state: every later chunk's
    # exp(csum_t) dy_t^T C_t, and the final state's, decayed back to it
    dh = torch.einsum(
        "bhcj,bhjpn->bhcpn",
        _masked_exp(later, acc[..., None, :nc] - acc[..., 1:, None]),
        torch.einsum("bhctp,bhct,bctn->bhcpn", dys, csum.exp(), cs_))
    if dstate is not None:
        dh += ((acc[..., -1:] - acc[..., 1:]).exp()[..., None, None]
               * dstate.float()[:, :, None])
    del csum
    grads = [torch.empty_like(t) for t in (xs, dts, as_, bs, cs_)]
    group = max(1, BWD_PAIR_ELEMENTS // (bsz * h * q * q))
    for i0 in range(0, nc, group):
        g = slice(i0, i0 + group)
        leaves = [t[:, :, g] for t in (xs, dts, as_)] + [bs[:, g], cs_[:, g]]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            y, h1 = _ssd_chunks(*leaves, states[:, :, g])
            got = torch.autograd.grad((y, h1), leaves,
                                      (dys[:, :, g], dh[:, :, g]))
        for out, gi in zip(grads[:3], got[:3]):
            out[:, :, g] = gi
        for out, gi in zip(grads[3:], got[3:]):
            out[:, g] = gi
    return tuple(gr.flatten(d, d + 1).narrow(d, 0, s).to(t.dtype)
                 for gr, t, d in zip(grads, ins, (2, 2, 2, 1, 1)))


class SSDScan(torch.autograd.Function):
    """(y, final state) = :func:`ssd_scan` (x, dt, a, b, c) with its
    gradient.  The forward is the kernel on CUDA tensors and the plain
    version on CPU tensors; it keeps the kernel's chunk-start states.  The
    backward is :func:`ssd_scan_bwd` (PyTorch ops; the reference has no
    backward kernel either)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        y, state, states = ssd_scan(x, dt, a, b, c, chunk_states=True)
        ctx.save_for_backward(x, dt, a, b, c, states)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        return ssd_scan_bwd(*ctx.saved_tensors, dy, dstate)
