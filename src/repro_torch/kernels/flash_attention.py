"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_fwd``
(the backward, ``flash_attention_bwd``, comes with training in a later
slice).  The kernel (``csrc/flash_attention_fwd.cu``) is the prefill
attention of the paged runner: the reference computes that with jnp
``attn.sdpa`` (``serving/model_runner.py``), whose Pallas counterpart is
this kernel.  It adds ``q_offset`` for chunked prefill: query row ``i``
sits at absolute position ``q_offset + i`` and key ``j`` at ``j``.

:func:`flash_attention_fwd_ref` is the plain PyTorch version.  It follows
the reference ``sdpa``'s order of operations and roundings exactly --
scores from the products in the input dtype, softmax in fp32, probs cast
back to the input dtype before the value product -- so the port's CPU
path reproduces the reference's bf16 numbers.  The kernel keeps scores
and probabilities in fp32 throughout, so on bf16 inputs it differs from
this version by the reference's own bf16 roundings (about 1e-2).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURE = {"flash_attention_fwd":
              (_P,) * 5 + (_I,) * 6 + (_L,) * 12 + (_I,) * 3
              + (_F, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> (o (B, H, Sq, D),
    lse (B, H, Sq) fp32), in the reference ``sdpa``'s rounding order."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (d ** -0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    scores = torch.where(ok, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D), any strides with a
    contiguous head dim -> (o (B, H, Sq, D), lse (B, H, Sq) fp32).

    On CUDA the output is stored in (B, Sq, H, D) memory order (the
    model layout) and returned as a (B, H, Sq, D) view, so the model's
    ``transpose(1, 2)`` back is free.  On CPU tensors this is
    :func:`flash_attention_fwd_ref`; on CUDA tensors it launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes bfloat16 or float32")
    if d not in HEAD_DIMS or h % kvh or v.shape != k.shape \
            or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head_dim "
                         f"must be one of {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"flash_attention_fwd: q_offset {q_offset} < 0")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lse
    lib = _build.library("flash_attention_fwd", _SIGNATURE)
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
