"""RWKV-6 WKV: the CUDA kernel's wrapper, its plain version, and the
autograd Function that gives it a gradient.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  The kernel
(``csrc/rwkv6_scan.cu``) replaces the Pallas ``rwkv6_wkv``; its source
note says what bounds it on the H100 and how the design answers.  The
dense serving path reaches it through ``models/rwkv6.wkv_chunked`` in
every RWKV-6 prefill, and training through :class:`WKV`, whose backward
(:func:`rwkv6_wkv_bwd`) is PyTorch ops from the chunk-start states the
kernel keeps: the reference differentiates its jnp scan with XLA's
autodiff and has no backward kernel.

The function is the recurrence of the reference oracle
``ref.rwkv6_wkv_ref``, from a zero state, per head::

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,       w_t = exp(logw_t)

computed exactly.  The reference's chunked forms (the Pallas kernel and
``models/rwkv6.wkv_chunked``) split the pairwise decay
``exp(csum[t-1] - csum[s])`` into ``exp(csum[t-1])`` and ``exp(-csum[s])``
and clamp each exponent at +-30; once a chunk's cumulative log-decay
falls below -30, both clamps bite and distant pairs get weight ~1
instead of ~0.  :func:`rwkv6_wkv_ref`, the plain version (the port's CPU
path and the yardstick the kernel is held against on the card), is a
chunked form too, but takes the pairwise decay as one exponent, which for
``s < t`` is never above 0 and needs no clamp.  A ragged tail is
zero-padded (k = v = 0 adds nothing, logw = 0 keeps the state), so the
final state is the state after exactly S tokens.

:func:`rwkv6_wkv_mirror` repeats the bf16 kernel's decomposition in plain
PyTorch -- chunks of :data:`KERNEL_CHUNK` tokens in sub-chunks of
:data:`KERNEL_SUB`, the pairs of two sub-chunks (and of a sub-chunk's two
halves) through a reference point between them, the pairs inside one
half exactly, then the states passed between chunks in order -- so that
the CPU tests can hold that decomposition against the reference's
per-step oracle; the backward recomputes its chunks the same
way (:func:`_wkv_chunks_sub`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = {"rwkv6_wkv": (_P,) * 9 + (_I,) * 4 + (_P, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# chunk length of the plain version (exact at any chunk)
CHUNK = 128
# the bf16 kernel's chunk (kQ in csrc/chunked_scan.cuh), sub-chunk (kSub
# in csrc/rwkv6_scan.cu) and widest head dim
KERNEL_CHUNK = 64
KERNEL_SUB = 16
KERNEL_MAX_DIM = 128


def _masked_exp(keep, x):
    """exp(x) where ``keep``, else 0; x is zeroed before ``exp`` where not
    kept, so neither the value nor its gradient overflows there."""
    return torch.where(keep, torch.where(keep, x, 0.0).exp(), 0.0)


def _wkv_chunks(r, k, v, logw, u, s0):
    """The WKV over a group of G chunks, each from its own start state, in
    fp32.  r, k, v, logw: (B, H, G, Q, hd); u: (H, hd); s0: (B, H, G, hd,
    hd) indexed [k][v] -> (o (B, H, G, Q, hd), each chunk's end state).
    ``csum`` is the inclusive sum of logw per channel in each chunk,
    ``excl`` the sum through the token before; every exponent taken is
    ``excl[t] - csum[s]`` for ``s < t``, ``excl[t]``, ``total - csum[s]``
    or ``total``, so never above 0 (the masked pairs' exponents are zeroed
    before ``exp``, so their gradients stay finite too)."""
    q = r.shape[-2]
    before = torch.ones(q, q, dtype=torch.bool,
                        device=r.device).tril(-1)[..., None]  # s < t
    csum = logw.cumsum(-2)                                # through t
    excl = csum - logw                                    # through t - 1
    total = csum[..., -1:, :]                             # (B, H, G, 1, hd)
    # the start state, decayed from the chunk start through token t - 1
    o = torch.einsum("...tk,...kv->...tv", r * excl.exp(), s0)
    # within the chunk, s < t: decay exp(excl[t] - csum[s]) per channel
    diff = excl[..., :, None, :] - csum[..., None, :, :]
    pair = _masked_exp(before, diff)
    att = torch.einsum("...tk,...tsk,...sk->...ts", r, pair, k)
    att = att + torch.diag_embed(                         # bonus, s = t
        (r * k * u.float()[:, None, None, :]).sum(-1))
    o = o + torch.einsum("...ts,...sv->...tv", att, v)
    s1 = (s0 * total.exp().transpose(-1, -2)
          + torch.einsum("...tk,...tv->...kv", k * (total - csum).exp(), v))
    return o, s1


def _pad_chunks(t, nc, q):
    """(B, H, S, hd) ``t`` in fp32, zero-padded to ``nc * q`` tokens and
    split into (nc, q)."""
    t = t.float()
    pad = nc * q - t.shape[2]
    return (F.pad(t, (0, 0, 0, pad)) if pad else t).unflatten(2, (nc, q))


def rwkv6_wkv_ref(r, k, v, logw, u):
    """r, k, v, logw: (B, H, S, hd); u: (H, hd) -> (o (B, H, S, hd) fp32,
    final state (B, H, hd, hd) fp32 indexed [k][v]), in chunks of
    :data:`CHUNK` tokens."""
    b, h, s, hd = r.shape
    cs = max(min(CHUNK, s), 1)
    nc = max(-(-s // cs), 1)
    ins = [_pad_chunks(t, nc, cs) for t in (r, k, v, logw)]
    state = torch.zeros((b, h, 1, hd, hd), dtype=torch.float32,
                        device=r.device)
    outs = []
    for i in range(nc):
        o, state = _wkv_chunks(*(t[:, :, i:i + 1] for t in ins), u, state)
        outs.append(o)
    return torch.cat(outs, dim=2).flatten(2, 3)[:, :, :s], state[:, :, 0]


def _wkv_chunks_sub(r, k, v, logw, u, s0, sub=KERNEL_SUB):
    """:func:`_wkv_chunks` -- the same arguments and results -- in the bf16
    kernel's decomposition, which holds no (chunk, chunk, hd) pair tensor:
    rows t of sub-chunk i of ``sub`` tokens against columns s of earlier
    sub-chunks as ``(r_t exp(excl_t - rho)) . (k_s exp(rho - csum_s))``,
    with ``rho`` the sum through the token before sub-chunk i; the
    sub-chunk's upper half against its lower half the same way, through
    the sum at the lower half's last token; the pairs ``s < t`` inside a
    half exactly, ``sum_k r_tk k_sk exp(excl_tk - csum_sk)``, plus the
    bonus at ``s = t``.  Every exponent is at most 0 (those of masked
    pairs are zeroed before ``exp``), so no factor exceeds 1 and the
    gradients stay finite.  The chunk must be a multiple of ``sub``, and
    ``sub`` even."""
    q = r.shape[-2]
    n_sub, half = q // sub, sub // 2
    lead = r.shape[:-2]
    dev = r.device
    csum = logw.cumsum(-2)                                # through t
    excl = csum - logw                                    # through t - 1
    total = csum[..., -1:, :]
    # earlier sub-chunks, through rho_i = csum[sub * i - 1] (rho_0 unused)
    rho = F.pad(csum[..., sub - 1:q - 1:sub, :], (0, 0, 1, 0))
    rows = (r.unflatten(-2, (n_sub, sub))
            * (excl.unflatten(-2, (n_sub, sub)) - rho[..., None, :]).exp())
    earlier = (torch.arange(q, device=dev)[None, :]
               < sub * torch.arange(n_sub, device=dev)[:, None])[..., None]
    up = rho[..., :, None, :] - csum[..., None, :, :]     # (.., n_sub, q, hd)
    cols = k[..., None, :, :] * _masked_exp(earlier, up)
    att = torch.einsum("...itk,...isk->...its", rows, cols).flatten(-3, -2)
    # a sub-chunk's upper half against its lower half, through the sum at
    # the lower half's last token
    r4, k4, e4, c4 = (t.unflatten(-2, (n_sub, 2, half))
                      for t in (r, k, excl, csum))
    rho2 = c4[..., 0, -1:, :]
    mid = torch.einsum("...tk,...sk->...ts",
                       r4[..., 1, :, :] * (e4[..., 1, :, :] - rho2).exp(),
                       k4[..., 0, :, :] * (rho2 - c4[..., 0, :, :]).exp())
    # inside each half exactly, and the bonus at s = t
    r8, k8, e8, c8 = (t.unflatten(-2, (q // half, half))
                      for t in (r, k, excl, csum))
    before = torch.ones(half, half, dtype=torch.bool,
                        device=dev).tril(-1)[..., None]
    diff = e8[..., :, None, :] - c8[..., None, :, :]
    pair = _masked_exp(before, diff)
    inner = (torch.einsum("...tk,...tsk,...sk->...ts", r8, pair, k8)
             + torch.diag_embed(
                 (r8 * k8 * u.float()[:, None, None, None, :]).sum(-1)))
    inner = inner.unflatten(-3, (n_sub, 2))
    block = torch.cat([
        torch.cat([inner[..., 0, :, :], torch.zeros_like(mid)], -1),
        torch.cat([mid, inner[..., 1, :, :]], -1)], -2)  # (.., n_sub, sub^2)
    eye = torch.eye(n_sub, dtype=block.dtype, device=dev)
    att = att + torch.einsum("...iab,ij->...iajb", block,
                             eye).reshape(*lead, q, q)
    o = (torch.einsum("...ts,...sv->...tv", att, v)
         + torch.einsum("...tk,...kv->...tv", r * excl.exp(), s0))
    s1 = (s0 * total.exp().transpose(-1, -2)
          + torch.einsum("...tk,...tv->...kv", k * (total - csum).exp(), v))
    return o, s1


def rwkv6_wkv_mirror(r, k, v, logw, u, chunk=KERNEL_CHUNK, sub=KERNEL_SUB):
    """The bf16 kernel's decomposition, in plain PyTorch and fp32; the
    arguments and results of :func:`rwkv6_wkv_ref`.  Every chunk's own
    state ``(k exp(total - csum))^T V`` at once, the states carried
    across the chunks in order, then every chunk's output from the state
    before it at once (:func:`_wkv_chunks_sub`: pairs through reference
    points, ``o += (r exp(excl)) S_prev``).  Every exponent is at most
    0."""
    b, h, s, hd = r.shape
    nc = max(-(-s // chunk), 1)
    r32, k32, v32, lw = (_pad_chunks(t, nc, chunk) for t in (r, k, v, logw))
    csum = lw.cumsum(3)
    total = csum[..., -1:, :]                         # (B, H, nc, 1, hd)
    own = torch.einsum("...sk,...sv->...kv", k32 * (total - csum).exp(), v32)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * total[:, :, i, 0, :, None].exp() + own[:, :, i]
    o, _ = _wkv_chunks_sub(r32, k32, v32, lw, u, torch.stack(prev, dim=2),
                           sub)
    return o.flatten(2, 3)[:, :, :s], state


def rwkv6_wkv(r, k, v, logw, u, *, chunk_states: bool = False):
    """r, k, v: (B, H, S, hd) bf16 or fp32 alike; logw: (B, H, S, hd) fp32;
    u: (H, hd) -- any strides with a contiguous last dim.  Returns (o (B,
    H, S, hd) fp32, stored in (B, S, H, hd) memory order, the model's
    layout; final state (B, H, hd, hd) fp32), from a zero state.  With
    ``chunk_states`` a third result: the state before each chunk of
    :data:`KERNEL_CHUNK` tokens, (B, H, ceil(S / 64), hd, hd) fp32, which
    the bf16 kernel leaves in its ``states`` buffer after its second
    launch; None where the route keeps none (CPU tensors, fp32).

    On CPU tensors this is :func:`rwkv6_wkv_ref`.  On CUDA tensors it
    launches the kernel, or raises: bf16 takes the chunked form on the
    tensor cores (three CUDA launches, counted as one; hd at most
    :data:`KERNEL_MAX_DIM`), fp32 steps the recurrence token by token."""
    if r.device.type == "cpu":
        out = rwkv6_wkv_ref(r, k, v, logw, u)
        return out + (None,) if chunk_states else out
    b, h, s, hd = r.shape
    if any(t.device != r.device for t in (k, v, logw, u)):
        raise ValueError("rwkv6_wkv: tensors on different devices")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or logw.dtype != torch.float32:
        raise ValueError(f"rwkv6_wkv: dtypes r={r.dtype} k={k.dtype} "
                         f"v={v.dtype} logw={logw.dtype}; r, k, v bfloat16 "
                         "or float32 alike, logw float32")
    if any(t.shape != r.shape for t in (k, v, logw)) or u.shape != (h, hd) \
            or hd > 256 or (r.dtype == torch.bfloat16 and hd > KERNEL_MAX_DIM):
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}, logw {tuple(logw.shape)}, u "
                         f"{tuple(u.shape)} (head dim at most 256; at most "
                         f"{KERNEL_MAX_DIM} in bf16)")
    r, k, v, logw = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, logw))
    u = u.float().contiguous()
    o = torch.empty((b, s, h, hd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    # the bf16 kernel's buffers: each chunk's own state, which its second
    # launch replaces by the state before the chunk, and log-decays
    nc = -(-s // KERNEL_CHUNK) if r.dtype == torch.bfloat16 else 0
    states = torch.empty((b, h, nc, hd, hd), dtype=torch.float32,
                         device=r.device)
    if s == 0:
        state.zero_()
    else:
        totals = torch.empty((b, h, nc, hd), dtype=torch.float32,
                             device=r.device)
        strides = (ctypes.c_longlong * 15)(
            *(st for t in (r, k, v, logw, o) for st in t.stride()[:3]))
        lib = _build.library("rwkv6_scan", _SIGNATURE)
        code = lib.rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), o.data_ptr(), state.data_ptr(), states.data_ptr(),
            totals.data_ptr(), b, h, s, hd,
            ctypes.addressof(strides), _DTYPES[r.dtype], _build.stream_ptr(r))
        _build.check(code, "rwkv6_wkv")
        rwkv6_wkv.launches += 1
    if not chunk_states:
        return o, state
    return o, state, (states if nc else None)


rwkv6_wkv.launches = 0


# the backward's chunk: the bf16 kernel's, whose chunk-start states it
# takes as they are
BWD_CHUNK = KERNEL_CHUNK
# fp32 elements of the pair-sized tensors -- a chunk's (chunk x chunk)
# scores and its halves' (half x half x hd) exact pairs -- that a group of
# chunks may hold in the backward (512 MiB): it bounds the group
BWD_PAIR_ELEMENTS = 1 << 27


def rwkv6_wkv_bwd(r, k, v, logw, u, states, do, dstate):
    """The gradient of :func:`rwkv6_wkv` -> (dr, dk, dv, dlogw, du), each
    in its input's dtype and shape, from the inputs, the states before
    each chunk of :data:`BWD_CHUNK` tokens (``states``, the kernel's;
    None: computed here), do (B, H, S, hd) and the final state's gradient
    ``dstate`` (B, H, hd, hd) (either may be None: zero).

    PyTorch ops, the counterpart of the reference's autodiff of
    ``lax.scan(jax.remat(per_chunk))``: every chunk's end-state gradient
    first (the reverse of the forward's pass over the states, ``dS_prev =
    diag(exp(total)) dS + sum_t (r_t exp(excl_t))^T do_t``, summed in
    closed form over the chunks), then each group of chunks recomputed
    from its start states and differentiated by autograd with those
    gradients.  The recompute takes the bf16 kernel's decomposition
    (:func:`_wkv_chunks_sub`), whose exact pairs are only those inside
    each half sub-chunk of :data:`KERNEL_SUB` // 2 tokens, so a group
    holds at most :data:`BWD_PAIR_ELEMENTS` pair elements (28 chunks at
    rwkv6-7b's 64 heads of 64 and 2 sequences) and nothing holds the
    whole sequence's pairs.  Exact across chunks and ragged tails (zero
    padding adds nothing and decays nothing), at any decay: no exponent
    is clamped and none exceeds 0."""
    b, h, s, hd = r.shape
    if s == 0:
        return tuple(torch.zeros_like(t) for t in (r, k, v, logw, u))
    q = BWD_CHUNK
    nc = -(-s // q)
    rs, ks, vs, ls = (_pad_chunks(t, nc, q) for t in (r, k, v, logw))
    dos = _pad_chunks(do, nc, q) if do is not None else rs.new_zeros(rs.shape)
    csum = ls.cumsum(-2)
    # the decay between two chunk boundaries, per channel k: acc[c] sums
    # the log-decays of the chunks before c, so exp(acc[j] - acc[c]) (j >=
    # c) decays row k of a state from boundary c to boundary j
    acc = F.pad(csum[..., -1, :].cumsum(-2), (0, 0, 1, 0))  # (B,H,nc+1,hd)
    later = torch.ones(nc, nc, dtype=torch.bool,
                       device=r.device).triu(1)[..., None]
    if states is None:            # S before chunk c: own states j < c
        own = torch.einsum("...tk,...tv->...kv",
                           ks * (csum[..., -1:, :] - csum).exp(), vs)
        states = torch.einsum(
            "bhcjk,bhjkv->bhckv",
            _masked_exp(later.transpose(0, 1), acc[..., :nc, None, :]
                        - acc[..., None, 1:, :]), own)
        del own
    # the gradient of each chunk's end state: every later chunk's
    # (r_t exp(excl_t))^T do_t, and the final state's, decayed back to it
    ds = torch.einsum(
        "bhcjk,bhjkv->bhckv",
        _masked_exp(later, acc[..., None, :nc, :] - acc[..., 1:, None, :]),
        torch.einsum("...tk,...tv->...kv", rs * (csum - ls).exp(), dos))
    if dstate is not None:
        ds += ((acc[..., -1:, :] - acc[..., 1:, :]).exp()[..., None]
               * dstate.float()[:, :, None])
    del csum
    grads = [torch.empty_like(t) for t in (rs, ks, vs, ls)]
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    group = max(1, BWD_PAIR_ELEMENTS
                // (b * h * q * (q + KERNEL_SUB // 2 * hd)))
    for i0 in range(0, nc, group):
        g = slice(i0, i0 + group)
        leaves = [t[:, :, g].detach().requires_grad_(True)
                  for t in (rs, ks, vs, ls)]
        ug = u.detach().float().requires_grad_(True)
        with torch.enable_grad():
            o, s1 = _wkv_chunks_sub(*leaves, ug, states[:, :, g])
            got = torch.autograd.grad((o, s1), leaves + [ug],
                                      (dos[:, :, g], ds[:, :, g]))
        for out, gi in zip(grads, got[:4]):
            out[:, :, g] = gi
        du += got[4]
    return tuple(gr.flatten(2, 3)[:, :, :s].to(t.dtype)
                 for gr, t in zip(grads, (r, k, v, logw))) + (du.to(u.dtype),)


class WKV(torch.autograd.Function):
    """(o, final state) = :func:`rwkv6_wkv` (r, k, v, logw, u) with its
    gradient.  The forward is the kernel on CUDA tensors and the plain
    version on CPU tensors; it keeps the kernel's chunk-start states.  The
    backward is :func:`rwkv6_wkv_bwd` (PyTorch ops; the reference has no
    backward kernel either)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        o, state, states = rwkv6_wkv(r, k, v, logw, u, chunk_states=True)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        return rwkv6_wkv_bwd(*ctx.saved_tensors, do, dstate)
