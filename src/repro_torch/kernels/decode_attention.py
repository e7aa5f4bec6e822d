"""Decode attention over a contiguous KV cache: the CUDA kernel's wrapper
and its plain versions.

Counterpart of ``repro/kernels/decode_attention.py``.  The kernel
(``csrc/decode_attention.cu``) replaces the Pallas ``decode_attention``;
its source note says what bounds it on the H100 and how the design
answers: each lane's cache is cut into splits of ``keys_per_split`` keys
(:func:`split_keys`, from the cache length and the SM count alone), each
split writes a partial softmax state and a second kernel combines them.
The dense serving path reaches it through
``models/attention.gqa_decode_sdpa``, the function the reference computes
in jnp.

:func:`decode_attention_ref` is the plain PyTorch version: the port's CPU
path and the yardstick the kernel is held against on the card.  It
follows the reference ``gqa_decode_sdpa``'s order of operations and
roundings -- scores from the products in the input dtype, softmax in
fp32, probs cast back to the input dtype before the value product -- so
the port's CPU path reproduces the reference's bf16 numbers.  The kernel
keeps scores and probabilities in fp32 throughout, so on bf16 inputs it
differs from that version by the reference's own roundings; on the card
the two are compared on fp32 copies.  :func:`decode_split_ref` repeats
the kernel's split and combine in plain PyTorch, for the CPU tests.

With ``return_lse`` each function returns a block's partial softmax
state: the output in fp32 (probabilities and sums kept in fp32, not
rounded to the input dtype) and every query row's log-sum-exp of its
scaled, masked scores, (B, H) fp32, -inf for a lane of valid length 0.
A rank that holds one block of a sequence-sharded cache hands both to
the merge of the ranks' partial states
(``sharding/collectives.combine_softmax_parts``), which rounds once.
The kernel's combine writes the lse from the (m, l) it reduces anyway;
such a call counts in ``decode_attention.launches`` and in
``decode_attention.lse_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
# fp32 at head dim 256 would need more shared memory than a block has
FP32_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# a split is a whole number of these keys: two steps of the split
# kernel's 4 warps x 16 keys, so each warp has a load in flight behind its
# first step
SPLIT_UNIT = 128
# blocks a split grid aims at per SM: splits past a lane's valid length
# exit at once, and the grid cannot know the valid lengths, so it is
# over-provisioned
BLOCKS_PER_SM = 8
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {"decode_attention": (_P,) * 8 + (_I,) * 7 + (_F, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def split_keys(b: int, kvh: int, s: int, sms: int):
    """(keys_per_split, splits) of the kernel's (lane, KV head, split)
    grid, from the cache length ``s`` and the SM count alone (never the
    valid lengths, so the launch reads nothing on the host): enough splits
    that ``b * kvh * splits`` reaches ``BLOCKS_PER_SM * sms`` blocks, each
    a whole number of ``SPLIT_UNIT`` keys, at most one split per unit."""
    units = max(1, -(-s // SPLIT_UNIT))
    want = -(-BLOCKS_PER_SM * sms // max(b * kvh, 1))
    kps = SPLIT_UNIT * max(1, units // want)
    return kps, -(-s // kps)


def _lengths(valid_len, b: int, device) -> torch.Tensor:
    """``valid_len`` as a (B,) int32 tensor on ``device`` (a scalar is
    every lane's length)."""
    return torch.as_tensor(valid_len, dtype=torch.int32,
                           device=device).expand(b)


def decode_attention_ref(q, k, v, valid_len, return_lse: bool = False):
    """q: (B, H, D); k, v: (B, KV, S, D); valid_len: scalar or (B,) ->
    (B, H, D) in q's dtype, in the reference ``gqa_decode_sdpa``'s rounding
    order.  A lane with valid length 0 returns zeros, as the kernel does.
    With ``return_lse``, (out, lse (B, H)), both fp32: the probabilities
    are not rounded to the input dtype, as the kernel keeps them."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d)
    scores = torch.matmul(qg, k.transpose(-1, -2)).float() * (d ** -0.5)
    vlen = _lengths(valid_len, b, q.device)
    ok = torch.arange(s, device=q.device)[None, :] < vlen[:, None]
    ok = ok[:, None, None, :]                            # (B, 1, 1, S)
    masked = torch.where(ok, scores, NEG_INF)
    probs = torch.where(ok, torch.softmax(masked, dim=-1), 0.0)
    if not return_lse:
        return torch.matmul(probs.to(q.dtype), v).reshape(b, h, d)
    out = torch.matmul(probs, v.float()).reshape(b, h, d)
    lse = torch.logsumexp(torch.where(ok, scores, -torch.inf), dim=-1)
    return out, lse.reshape(b, h)


def decode_split_ref(q, k, v, valid_len, keys_per_split: int,
                     return_lse: bool = False):
    """The kernel's split and combine in plain PyTorch, in fp32: each run
    of ``keys_per_split`` keys gives a partial (m, l, acc) per query row
    (m = -inf, l = 0 where it holds no key below the valid length), and the
    partials are combined with weights exp(m - max m), empty ones adding
    nothing.  A lane with valid length 0 returns zeros; one above S reads S
    keys.  Returns (B, H, D) in q's dtype; with ``return_lse`` that output
    in fp32 and the rows' max m + log(sum of the weighted l), (B, H) fp32,
    -inf for an empty row, as the kernel's combine writes them."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    splits = -(-s // keys_per_split)
    pad = splits * keys_per_split - s
    scores = torch.einsum("bkgd,bksd->bkgs", q.float().reshape(b, kvh, g, d),
                          k.float()) * (d ** -0.5)
    vlen = _lengths(valid_len, b, q.device)
    ok = torch.arange(s, device=q.device)[None, :] < vlen[:, None]
    scores = torch.where(ok[:, None, None, :], scores, -torch.inf)
    scores = torch.nn.functional.pad(scores, (0, pad), value=-torch.inf) \
        .unflatten(-1, (splits, keys_per_split))         # (B, KV, G, c, s)
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).unflatten(
        2, (splits, keys_per_split))                     # (B, KV, c, s, D)
    m = scores.amax(-1)                                  # (B, KV, G, c)
    p = torch.exp(scores - torch.where(m == -torch.inf, 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgcs,bkcsd->bkgcd", p, vs)
    top = m.amax(-1, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0,
                    torch.exp(m - torch.where(top == -torch.inf, 0.0, top)))
    ll = (w * l).sum(-1, keepdim=True)
    out = ((w[..., None] * acc).sum(-2) / ll.clamp(min=1e-30)).reshape(
        b, h, d)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(top == -torch.inf, -torch.inf, top + ll.log())
    return out, lse.reshape(b, h)


def decode_attention(q, k, v, valid_len, return_lse: bool = False):
    """q: (B, H, D); k, v: (B, KV, S, D) bf16 or fp32; valid_len: scalar or
    (B,) int32.  Attends over positions ``[0, valid_len)`` of each lane,
    the G = H / KV query heads of a KV head together.  Returns (B, H, D) in
    q's dtype, and with ``return_lse`` (out, lse (B, H)), both fp32.  The kernel
    splits each lane's cache as :func:`split_keys` says, into fp32
    workspaces allocated here; one call is one launch of the count (a
    split kernel and a combine kernel on the card).

    On CPU tensors this is :func:`decode_attention_ref`; on CUDA tensors
    it launches the kernel or raises."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len, return_lse)
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"decode_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes q={q.dtype} k={k.dtype} "
                         f"v={v.dtype}; the kernel takes one of "
                         "bfloat16/float32 for all three")
    if d not in HEAD_DIMS or h % kvh or k.shape != (b, kvh, s, d) \
            or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head_dim "
                         f"must be one of {HEAD_DIMS}")
    if q.dtype == torch.float32 and d not in FP32_HEAD_DIMS:
        raise ValueError(f"decode_attention: float32 at head_dim {d} (q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}): the kernel "
                         f"takes fp32 at head dims {FP32_HEAD_DIMS} and "
                         f"bfloat16 at {HEAD_DIMS}")
    vlen = _lengths(valid_len, b, q.device).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or s == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if return_lse else out
    kps, splits = split_keys(b, kvh, s, _build.sm_count(q.device.index))
    ws_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                        device=q.device)
    ws_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                         device=q.device)
    lib = _build.library("decode_attention", _SIGNATURE)
    code = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vlen.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        ws_ml.data_ptr(), ws_acc.data_ptr(), b, h, kvh, s, d, kps, splits,
        d ** -0.5, _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    if return_lse:
        decode_attention.lse_launches += 1
        return out, lse
    return out


decode_attention.launches = 0
decode_attention.lse_launches = 0
