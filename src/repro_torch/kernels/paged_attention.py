"""Paged-attention decode: the CUDA kernel's wrapper and its plain versions.

Counterpart of ``repro/kernels/paged_attention.py``.  The kernel
(``csrc/paged_attention.cu``) replaces the Pallas ``paged_attention``;
its source note says what bounds it on the H100 and how the design
answers: the lane's table is cut into splits of ``pages_per_split``
entries (:func:`split_pages`), each split writes a partial softmax state
and a second kernel combines them.  :func:`paged_attention_ref` is the
plain PyTorch version with the reference oracle's semantics: the CPU path
of the port and the yardstick the kernel is held against on the card.
:func:`paged_attention_split_ref` repeats the kernel's split and combine
in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
# a token's D / 4 fp32 vectors of 16 bytes must fit a warp's 32 lanes
FP32_HEAD_DIMS = (16, 32, 64, 128)
# blocks a split grid aims at per SM: a linear lane's splits past its
# valid length exit at once, so the grid is over-provisioned
BLOCKS_PER_SM = 4
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {"paged_attention_decode":
              (_P,) * 8 + (_I,) * 10 + (_F, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def split_pages(b: int, kvh: int, max_pages: int, sms: int):
    """(pages_per_split, splits) of the kernel's (lane, KV head, split)
    grid: enough splits that ``b * kvh * splits`` reaches
    ``BLOCKS_PER_SM * sms`` blocks, at most one split per table entry."""
    want = -(-BLOCKS_PER_SM * sms // max(b * kvh, 1))
    pps = max(1, max_pages // want)
    return pps, -(-max_pages // pps)


def _slot_positions(slot, last, *, window: int, ring: bool, ring_tokens: int):
    """(abs position, valid?) of cache slots given the last written
    position ``last`` (= valid_len - 1).  Linear tables store position
    ``s`` at slot ``s``; ring tables store ``p`` at ``p % ring_tokens``,
    so a slot's occupant is the latest ``p' <= last`` congruent to it.
    ``window > 0`` also masks positions at or below ``last - window``."""
    pos = last - torch.remainder(last - slot, ring_tokens) if ring else slot
    ok = (pos >= 0) & (pos <= last)
    if window > 0:
        ok = ok & (pos > last - window)
    return pos, ok


def _gathered(q, k_pages, v_pages, page_table, valid_len, window, ring):
    """fp32 scores (B, H, S), the (B, 1, S) mask of live slots and the
    gathered values (B, S, H, D), S = max_pages * page."""
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = page_table.shape[1]
    safe = page_table.clamp(min=0).long()
    k = k_pages[safe].reshape(b, max_pages * page, kvh, d)
    v = v_pages[safe].reshape(b, max_pages * page, kvh, d)
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (d ** -0.5)
    vlen = torch.as_tensor(valid_len, device=q.device).expand(b)
    slot = torch.arange(max_pages * page, device=q.device)[None, None, :]
    in_page = (page_table >= 0).repeat_interleave(page, dim=1)[:, None, :]
    _, ok = _slot_positions(slot, vlen[:, None, None] - 1, window=window,
                            ring=ring, ring_tokens=max_pages * page)
    return scores, ok & in_page, v


def paged_attention_ref(q, k_pages, v_pages, page_table, valid_len, *,
                        window: int = 0, ring: bool = False):
    """Gather-based plain version (the reference oracle's math, in fp32)."""
    scores, mask, v = _gathered(q, k_pages, v_pages, page_table, valid_len,
                                window, ring)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask, probs, 0.0)   # fully-masked rows stay finite
    return torch.einsum("bhs,bshd->bhd", probs, v.float()).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, page_table, valid_len, *,
                              window: int = 0, ring: bool = False,
                              pages_per_split: int = 1):
    """The kernel's split and combine in plain PyTorch: each run of
    ``pages_per_split`` table entries gives a partial (m, l, acc) in fp32
    (m = -inf, l = 0 where it holds no live token), and the partials are
    combined with weights exp(m - max m), empty ones adding nothing."""
    b, h, d = q.shape
    page, max_pages = k_pages.shape[1], page_table.shape[1]
    scores, mask, v = _gathered(q, k_pages, v_pages, page_table, valid_len,
                                window, ring)
    splits = -(-max_pages // pages_per_split)
    pad = splits * pages_per_split * page - max_pages * page
    width = pages_per_split * page
    scores = torch.nn.functional.pad(scores, (0, pad)).unflatten(
        -1, (splits, width))
    mask = torch.nn.functional.pad(mask, (0, pad)).unflatten(
        -1, (splits, width))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).unflatten(
        1, (splits, width))
    scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(-1)                                     # (B, H, splits)
    p = torch.exp(scores - torch.where(m == -torch.inf, 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhcs,bcshd->bhcd", p, v)
    top = m.amax(-1, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0,
                    torch.exp(m - torch.where(top == -torch.inf, 0.0, top)))
    out = (w[..., None] * acc).sum(2) / (w * l).sum(-1, keepdim=True).clamp(
        min=1e-30)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, valid_len, *,
                    window: int = 0, ring: bool = False):
    """q: (B, H, D); k/v_pages: (P, page, KV, D) pool; page_table:
    (B, max_pages) int32 physical page ids, -1 padded; valid_len: (B,)
    int32 total tokens.  ``window > 0`` masks keys outside the last
    ``window`` positions; ``ring=True`` reads the table as a
    position-modular ring.  Returns (B, H, D) in q's dtype.  The kernel
    splits each lane's table as :func:`split_pages` says, into fp32
    workspaces allocated here.

    On CPU tensors this is :func:`paged_attention_ref`; on CUDA tensors
    it launches the kernel or raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, valid_len,
                                   window=window, ring=ring)
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = page_table.shape[1]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("valid_len", valid_len)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes q={q.dtype} "
                         f"k={k_pages.dtype} v={v_pages.dtype}; the kernel "
                         "takes one of bfloat16/float32 for all three")
    if d not in HEAD_DIMS or h % kvh or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: head_dim {d} (supported "
                         f"{HEAD_DIMS}), heads {h}/{kvh}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if q.dtype == torch.float32 and d not in FP32_HEAD_DIMS:
        raise ValueError(f"paged_attention: float32 pages at head_dim {d} "
                         f"(q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}): the kernel takes fp32 "
                         f"at head dims {FP32_HEAD_DIMS} and bfloat16 at "
                         f"{HEAD_DIMS}")
    if page_table.dtype != torch.int32 or page_table.shape[0] != b \
            or valid_len.dtype != torch.int32 or valid_len.shape != (b,):
        raise ValueError("paged_attention: page_table must be (B, maxp) "
                         "int32 and valid_len (B,) int32")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), \
        v_pages.contiguous()
    page_table, valid_len = page_table.contiguous(), valid_len.contiguous()
    out = torch.empty_like(q)
    if b == 0 or max_pages == 0:
        return out.zero_()
    pps, splits = split_pages(b, kvh, max_pages,
                              _build.sm_count(q.device.index))
    ws_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                        device=q.device)
    ws_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                         device=q.device)
    lib = _build.library("paged_attention", _SIGNATURE)
    code = lib.paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        ws_ml.data_ptr(), ws_acc.data_ptr(), b, h, kvh, d, page, max_pages,
        pps, splits, int(window), int(bool(ring)), d ** -0.5,
        _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
