"""RWKV-6 WKV: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  The kernel
(``csrc/rwkv6_scan.cu``) replaces the Pallas ``rwkv6_wkv``; its source
note says what bounds it on the H100 and how the design answers.  The
dense serving path reaches it through ``models/rwkv6.wkv_chunked`` in
every RWKV-6 prefill.

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
per-step oracle.
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


def rwkv6_wkv_ref(r, k, v, logw, u):
    """r, k, v, logw: (B, H, S, hd); u: (H, hd) -> (o (B, H, S, hd) fp32,
    final state (B, H, hd, hd) fp32 indexed [k][v]), in chunks of
    :data:`CHUNK` tokens."""
    b, h, s, hd = r.shape
    cs = max(min(CHUNK, s), 1)
    pad = (-s) % cs
    r32, k32, v32, lw = (t.float() for t in (r, k, v, logw))
    if pad:
        r32, k32, v32, lw = (F.pad(t, (0, 0, 0, pad))
                             for t in (r32, k32, v32, lw))
    u32 = u.float()[None, :, None, :]                     # (1, H, 1, hd)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    before = torch.ones(cs, cs, dtype=torch.bool,
                        device=r.device).tril(-1)[..., None]  # s < t
    outs = []
    for t0 in range(0, s + pad, cs):
        rc, kc, vc = (t[:, :, t0:t0 + cs] for t in (r32, k32, v32))
        csum = lw[:, :, t0:t0 + cs].cumsum(2)             # through t
        excl = csum - lw[:, :, t0:t0 + cs]                # through t - 1
        total = csum[:, :, -1:]                           # (B, H, 1, hd)
        # carried state, decayed from the chunk start through token t - 1
        o = torch.einsum("bhtk,bhkv->bhtv", rc * excl.exp(), state)
        # within the chunk, s < t: decay exp(excl[t] - csum[s]) per channel
        diff = excl[:, :, :, None, :] - csum[:, :, None, :, :]
        pair = torch.where(before, diff, float("-inf")).exp()
        att = torch.einsum("bhtk,bhtsk,bhsk->bhts", rc, pair, kc)
        att = att + torch.diag_embed((rc * kc * u32).sum(-1))   # bonus, s = t
        o = o + torch.einsum("bhts,bhsv->bhtv", att, vc)
        outs.append(o)
        kdec = kc * (total - csum).exp()
        state = (state * total.exp().transpose(-1, -2)
                 + torch.einsum("bhtk,bhtv->bhkv", kdec, vc))
    return torch.cat(outs, dim=2)[:, :, :s], state


def rwkv6_wkv_mirror(r, k, v, logw, u, chunk=KERNEL_CHUNK, sub=KERNEL_SUB):
    """The bf16 kernel's decomposition, in plain PyTorch and fp32; the
    arguments and results of :func:`rwkv6_wkv_ref`.  Every chunk at once:
    ``csum`` the inclusive sum of logw per channel, ``excl`` the sum
    through the token before.  Rows t of sub-chunk i against columns s of
    earlier sub-chunks: ``(r_t exp(excl_t - rho)) . (k_s exp(rho -
    csum_s))``, with ``rho`` the sum through the token before sub-chunk
    i; the sub-chunk's upper half against its lower half the same way,
    through the sum at the lower half's last token; the pairs ``s < t``
    inside a half exactly, ``sum_k r_tk k_sk exp(excl_tk - csum_sk)``,
    plus the bonus at ``s = t``.  Then ``o = A V`` and each chunk's own
    state ``(k exp(total - csum))^T V``; the states carried across the
    chunks in order; and ``o += (r exp(excl)) S_prev``.  Every exponent is
    at most 0."""
    b, h, s, hd = r.shape
    nc = max(-(-s // chunk), 1)
    pad = nc * chunk - s
    r32, k32, v32, lw = (F.pad(t.float(), (0, 0, 0, pad))
                         .unflatten(2, (nc, chunk))
                         for t in (r, k, v, logw))    # (B, H, nc, Q, hd)
    u32 = u.float()[None, :, None, None, :]
    csum = lw.cumsum(3)
    excl = F.pad(csum[..., :-1, :], (0, 0, 1, 0))     # through t - 1
    total = csum[..., -1:, :]                         # (B, H, nc, 1, hd)
    att = r32.new_zeros((b, h, nc, chunk, chunk))
    half = sub // 2
    before = torch.ones(half, half, dtype=torch.bool,
                        device=r.device).tril(-1)[..., None]  # s < t

    def through(rho_at, t0, t1, s0, s1):
        """Rows [t0, t1) against columns [s0, s1) through the reference
        point csum[rho_at], which lies between every such pair."""
        rho = csum[..., rho_at:rho_at + 1, :]
        rt = r32[..., t0:t1, :] * (excl[..., t0:t1, :] - rho).exp()
        kt = k32[..., s0:s1, :] * (rho - csum[..., s0:s1, :]).exp()
        att[..., t0:t1, s0:s1] = torch.einsum("...tk,...sk->...ts", rt, kt)

    for i in range(chunk // sub):
        t0, mid, t1 = i * sub, i * sub + half, (i + 1) * sub
        if i:
            through(t0 - 1, t0, t1, 0, t0)
        through(mid - 1, mid, t1, t0, mid)
        for h0, h1 in ((t0, mid), (mid, t1)):            # exactly
            rh, kh = r32[..., h0:h1, :], k32[..., h0:h1, :]
            diff = excl[..., h0:h1, None, :] - csum[..., None, h0:h1, :]
            pair = torch.where(before, torch.where(before, diff, 0.0).exp(),
                               0.0)
            att[..., h0:h1, h0:h1] = (
                torch.einsum("...tk,...tsk,...sk->...ts", rh, pair, kh)
                + torch.diag_embed((rh * kh * u32).sum(-1)))
    o = torch.einsum("...ts,...sv->...tv", att, v32)
    own = torch.einsum("...sk,...sv->...kv", k32 * (total - csum).exp(), v32)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * total[:, :, i, 0, :, None].exp() + own[:, :, i]
    o = o + torch.einsum("...tk,...kv->...tv", r32 * excl.exp(),
                         torch.stack(prev, dim=2))
    return o.flatten(2, 3)[:, :, :s], state


def rwkv6_wkv(r, k, v, logw, u):
    """r, k, v: (B, H, S, hd) bf16 or fp32 alike; logw: (B, H, S, hd) fp32;
    u: (H, hd) -- any strides with a contiguous last dim.  Returns (o (B,
    H, S, hd) fp32, stored in (B, S, H, hd) memory order, the model's
    layout; final state (B, H, hd, hd) fp32), from a zero state.

    On CPU tensors this is :func:`rwkv6_wkv_ref`.  On CUDA tensors it
    launches the kernel, or raises: bf16 takes the chunked form on the
    tensor cores (three CUDA launches, counted as one; hd at most
    :data:`KERNEL_MAX_DIM`), fp32 steps the recurrence token by token."""
    if r.device.type == "cpu":
        return rwkv6_wkv_ref(r, k, v, logw, u)
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
    if s == 0:
        return o, state.zero_()
    # the bf16 kernel's scratch: each chunk's state and log-decays
    nc = -(-s // KERNEL_CHUNK) if r.dtype == torch.bfloat16 else 0
    states = torch.empty((b, h, nc, hd, hd), dtype=torch.float32,
                         device=r.device)
    totals = torch.empty((b, h, nc, hd), dtype=torch.float32, device=r.device)
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
    return o, state


rwkv6_wkv.launches = 0
