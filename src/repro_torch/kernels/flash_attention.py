"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins the forward and backward kernels.

Counterpart of ``repro/kernels/flash_attention.py``: the forward
(``flash_attention_fwd``, ``csrc/flash_attention_fwd.cu``) and the two
backward passes of ``flash_attention_bwd`` -- dQ (``_dq_kernel``) and
dK/dV (``_dkv_kernel``), ``csrc/flash_attention_bwd.cu``.  Both kernels
add ``q_offset`` for chunked prefill: query row ``i`` sits at absolute
position ``q_offset + i`` and key ``j`` at ``j``.

:class:`FlashAttention` is the reference's ``jax.custom_vjp``
(``repro/kernels/ops.py``) as a ``torch.autograd.Function``: its forward
is the forward kernel and saves ``q, k, v, o, lse``; its backward runs
the dQ pass (which also computes ``delta = rowsum(dO * O)``) and then the
dK/dV pass.  The model's ``sdpa`` calls it on CUDA tensors; on CPU
tensors the model differentiates the plain forward directly.

The plain versions: :func:`flash_attention_fwd_ref` follows the
reference ``sdpa``'s order of operations and roundings exactly -- scores
from the products in the input dtype, softmax in fp32, probs cast back
to the input dtype before the value product -- so the port's CPU path
reproduces the reference's bf16 numbers.  Called with
``operand_dtype=torch.bfloat16`` it runs the bf16 forward kernel's
arithmetic instead: the online softmax over key tiles of ``block_k``
(the kernel's, :func:`fwd_block_k`), fp32 throughout except that p is rounded
to bf16 before the value product.  :func:`flash_attention_bwd_ref` is
the Pallas backward's arithmetic: fp32 throughout from the saved
``lse``, outputs rounded once.

Both kernels take two routes by dtype.  bf16 inputs -- every call of the
model -- go to tensor-core kernels (``mma.sync`` with bf16 operands,
fp32 accumulators), which round P (forward and backward) and dS
(backward) to bf16 where they become operands of O = P V, dV = P^T dO,
dK = dS^T Q and dQ = dS K, as every tensor-core flash kernel does; the
plain versions do the same with ``operand_dtype=torch.bfloat16``.  fp32
inputs go to SIMT kernels that keep every product in fp32, as the plain
versions' default ``operand_dtype=None`` does (the forward's default
then rounds only where its input dtype does, which fp32 does not).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# the head dims both kernels are built for: zamba2-2.7b's 80,
# phi-3-vision-4.2b's 96, the 64 and 128 of the other families and
# gemma3-12b's 256 (the backward's dK/dV kernel splits the columns of dK
# and dV over two warps a key slice there; csrc/flash_attention_bwd.cu)
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS
FWD_BLOCK_K = 64            # keys of the bf16 forward kernel's loop tile
FWD_BLOCK_K_WIDE = 32       # ... at head dim 256, where registers are short


def fwd_block_k(head_dim: int) -> int:
    """Keys of the bf16 forward kernel's loop tile at ``head_dim``."""
    return FWD_BLOCK_K_WIDE if head_dim > 128 else FWD_BLOCK_K
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_FWD = {"flash_attention_fwd":
        (_P,) * 5 + (_I,) * 6 + (_L,) * 12 + (_I,) * 3 + (_F, _I, _P)}
_BWD_ARGS = (_P,) * 8 + (_I,) * 6 + (_P,) + (_I,) * 3 + (_F, _I, _P)
_BWD = {"flash_attention_bwd_dq": _BWD_ARGS,
        "flash_attention_bwd_dkv": _BWD_ARGS}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _visible(sq: int, sk: int, causal: bool, window: int, q_offset: int,
             device) -> torch.Tensor:
    """(Sq, Sk) bool: may query row i attend key j."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0, operand_dtype=None,
                            block_k: int = FWD_BLOCK_K):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> (o (B, H, Sq, D),
    lse (B, H, Sq) fp32), in the reference ``sdpa``'s rounding order.

    ``operand_dtype`` (e.g. ``torch.bfloat16``): the bf16 kernel's
    arithmetic instead (:func:`_fwd_tiles`), p rounded to that dtype
    before the value product, over key tiles of ``block_k``."""
    if operand_dtype is not None:
        return _fwd_tiles(q, k, v, causal, window, q_offset, operand_dtype,
                          block_k)
    sq, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (d ** -0.5)
    ok = _visible(sq, k.shape[2], causal, window, q_offset, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


def _fwd_tiles(q, k, v, causal, window, q_offset, operand_dtype, block_k):
    """The online softmax over key tiles of ``block_k`` aligned at key 0,
    in fp32: running max m, p = exp(s - m) (0 where masked), l summed from
    the fp32 p, p rounded to ``operand_dtype`` for p.V; o = acc / l and
    lse = m + log(l), l clamped at 1e-30 (m taken as -1e30 for a row that
    sees no key)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    q32 = q.float()
    k32 = k.float().repeat_interleave(g, dim=1)
    v32 = v.float().repeat_interleave(g, dim=1)
    ok = _visible(sq, sk, causal, window, q_offset, q.device)
    m = torch.full((b, h, sq, 1), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        s = torch.matmul(q32, k32[:, :, k0:k0 + block_k].transpose(-1, -2))
        s = torch.where(ok[:, k0:k0 + block_k], s * (d ** -0.5), -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_operand(p, operand_dtype),
                                         v32[:, :, k0:k0 + block_k])
        m = m_new
    lc = l.clamp(min=1e-30)
    lse = torch.where(m == -torch.inf, NEG_INF, m) + torch.log(lc)
    return (acc / lc).to(q.dtype), lse[..., 0]


def _check(name, q, k, v, q_offset, *others, head_dims=HEAD_DIMS):
    """Raise on what the CUDA kernels do not take."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    if any(t.device != q.device for t in (k, v) + others):
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes bfloat16 or float32")
    if d not in head_dims or h % kvh or v.shape != k.shape \
            or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head_dim must be one of "
                         f"{head_dims}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")


def _unit_last(*ts):
    """The tensors with a contiguous head dim (copies only where needed)."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _rows_aligned(*ts):
    """bf16 tensors for the tensor-core kernels' ``cp.async``: each
    (batch, head, sequence) row 16-byte aligned, copied only where the base
    pointer or a stride is not (the model's layouts always are)."""
    def ok(t):
        return t.data_ptr() % 16 == 0 and all(
            s % 8 == 0 for s in t.stride()[:3])
    return tuple(t if t.dtype != torch.bfloat16 or ok(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _model_layout(b, s, n, d, like):
    """(B, n, S, D) output stored in (B, S, n, D) memory order, the
    model's layout, so the model's ``transpose(1, 2)`` back is free."""
    return torch.empty((b, s, n, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D), any strides with a
    contiguous head dim -> (o (B, H, Sq, D), lse (B, H, Sq) fp32).

    On CUDA the output is stored in (B, Sq, H, D) memory order (the
    model layout) and returned as a (B, H, Sq, D) view.  bf16 launches
    the tensor-core kernel, which rounds p to bf16 for p.V (its plain
    version: ``operand_dtype=torch.bfloat16``; a bf16 tensor whose rows
    are not 16-byte aligned is copied first); fp32 the SIMT kernel, fp32
    throughout.  On CPU tensors this is :func:`flash_attention_fwd_ref`;
    on CUDA tensors it launches the kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    _check("flash_attention_fwd", q, k, v, q_offset)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    q, k, v = _rows_aligned(*_unit_last(q, k, v))
    o = _model_layout(b, sq, h, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lse
    lib = _build.library("flash_attention_fwd", _FWD)
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, kvh, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(bool(causal)), int(window), int(q_offset), d ** -0.5,
        _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward: plain versions
# ---------------------------------------------------------------------------

def _operand(x, dtype):
    """``x`` rounded to ``dtype`` (a tensor-core product's operand type)
    and back to fp32; ``None``: ``x`` as it is."""
    return x if dtype is None else x.to(dtype).float()


def _bwd_probs(q, k, v, lse, delta, do, causal, window, q_offset):
    """fp32 p and ds (B, H, Sq, Sk) recomputed from ``lse``, with the KV
    heads expanded to the query heads; also the fp32 q, expanded k, dO."""
    d = q.shape[3]
    g = q.shape[1] // k.shape[1]
    q32, do32 = q.float(), do.float()
    k32 = k.float().repeat_interleave(g, dim=1)
    v32 = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q32, k32.transpose(-1, -2)) * (d ** -0.5)
    ok = _visible(q.shape[2], k.shape[2], causal, window, q_offset, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * (d ** -0.5)
    return p, ds, q32, k32, do32


def flash_attention_dq_ref(q, k, v, o, lse, do, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0,
                           operand_dtype=None):
    """Plain version of the dQ pass -> (dq in q's dtype, delta (B, H, Sq)
    fp32 = rowsum(dO * O)).  fp32 arithmetic; ``operand_dtype=
    torch.bfloat16`` rounds ds before ds.K, as the bf16 kernel does."""
    delta = (do.float() * o.float()).sum(-1)
    _, ds, _, k32, _ = _bwd_probs(q, k, v, lse, delta, do, causal, window,
                                  q_offset)
    return (torch.matmul(_operand(ds, operand_dtype), k32).to(q.dtype),
            delta)


def flash_attention_dkv_ref(q, k, v, lse, delta, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            operand_dtype=None):
    """Plain version of the dK/dV pass -> (dk, dv) in k's dtype, each
    summed over the G query heads of its KV head.  fp32 arithmetic;
    ``operand_dtype=torch.bfloat16`` rounds p and ds (ds formed from the
    unrounded p) before p^T.dO and ds^T.Q, as the bf16 kernel does."""
    kvh = k.shape[1]
    g = q.shape[1] // kvh
    p, ds, q32, _, do32 = _bwd_probs(q, k, v, lse, delta, do, causal, window,
                                     q_offset)
    dv = torch.matmul(_operand(p, operand_dtype).transpose(-1, -2), do32)
    dk = torch.matmul(_operand(ds, operand_dtype).transpose(-1, -2), q32)
    return (dk.unflatten(1, (kvh, g)).sum(2).to(k.dtype),
            dv.unflatten(1, (kvh, g)).sum(2).to(v.dtype))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            operand_dtype=None):
    """Plain version of the whole backward -> (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              operand_dtype=operand_dtype)
    dq, delta = flash_attention_dq_ref(q, k, v, o, lse, do, **kw)
    return (dq,) + flash_attention_dkv_ref(q, k, v, lse, delta, do, **kw)


# ---------------------------------------------------------------------------
# Backward: kernel wrappers
# ---------------------------------------------------------------------------

def _launch_bwd(fn, ptrs, b, h, kvh, sq, sk, d, tensors, causal, window,
                q_offset, q):
    strides = (ctypes.c_longlong * 18)(
        *(s for t in tensors for s in t.stride()[:3]))
    lib = _build.library("flash_attention_bwd", _BWD)
    code = getattr(lib, fn)(
        *(t.data_ptr() for t in ptrs), b, h, kvh, sq, sk, d,
        ctypes.addressof(strides), int(bool(causal)), int(window),
        int(q_offset), d ** -0.5, _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(code, fn)


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0):
    """The dQ pass: shapes as :func:`flash_attention_fwd`, plus ``o`` and
    ``do`` (B, H, Sq, D) and ``lse`` (B, H, Sq) fp32 -> (dq (B, H, Sq, D)
    stored in (B, Sq, H, D) order, delta (B, H, Sq) fp32).

    Any strides with a contiguous head dim are read in place (a tensor
    whose head dim is strided is copied, and a bf16 one whose rows are not
    16-byte aligned).  bf16 launches the tensor-core kernel, which rounds
    ds to bf16 for ds.K (its plain version: ``operand_dtype=
    torch.bfloat16``); fp32 the SIMT kernel, fp32 throughout.  On CPU
    tensors this is :func:`flash_attention_dq_ref` in fp32; on CUDA
    tensors it launches the kernel or raises."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, o, lse, do, **kw)
    _check("flash_attention_bwd_dq", q, k, v, q_offset, o, do, lse,
           head_dims=BWD_HEAD_DIMS)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.shape != (b, h, sq):
        raise ValueError("flash_attention_bwd_dq: o and do must match q, "
                         "lse be (B, H, Sq)")
    q, k, v, o, do = _rows_aligned(*_unit_last(q, k, v, o, do))
    lse = lse.float().contiguous()
    dq = _model_layout(b, sq, h, d, q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return dq, delta
    _launch_bwd("flash_attention_bwd_dq", (q, k, v, o, do, lse, delta, dq),
                b, h, kvh, sq, sk, d, (q, k, v, o, do, dq), causal, window,
                q_offset, q)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """The dK/dV pass, from the ``delta`` of the dQ pass -> (dk, dv)
    (B, KVH, Sk, D), stored in (B, Sk, KVH, D) order.  Strides and the
    two routes as :func:`flash_attention_bwd_dq`; the bf16 kernel rounds p
    and ds for p^T.dO and ds^T.Q.  On CPU tensors this is
    :func:`flash_attention_dkv_ref` in fp32; on CUDA tensors it launches
    the kernel or raises."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, lse, delta, do, **kw)
    _check("flash_attention_bwd_dkv", q, k, v, q_offset, do, lse, delta,
           head_dims=BWD_HEAD_DIMS)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype \
            or lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError("flash_attention_bwd_dkv: do must match q, lse and "
                         "delta be (B, H, Sq)")
    q, k, v, do = _rows_aligned(*_unit_last(q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk, dv = _model_layout(b, sk, kvh, d, k), _model_layout(b, sk, kvh, d, v)
    if sk == 0:
        return dk, dv
    _launch_bwd("flash_attention_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                b, h, kvh, sq, sk, d, (q, k, v, do, dk, dv), causal, window,
                q_offset, q)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """The reference's ``flash_attention_bwd``: -> (dq, dk, dv), through
    the dQ pass and then the dK/dV pass (kernels on CUDA tensors, their
    plain versions on CPU tensors)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the kernels' gradient: the counterpart
    of the reference's ``ops.flash_attention`` custom VJP.

    ``FlashAttention.apply(q, k, v, causal, window, q_offset)``, shapes as
    :func:`flash_attention_fwd` -> o (B, H, Sq, D).  The saved ``o`` is
    the forward's (B, H, Sq, D) view of (B, Sq, H, D) memory; the
    gradients come back in the same layouts as the inputs of a model
    that passes ``transpose(1, 2)`` views."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, q_offset=0):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None
