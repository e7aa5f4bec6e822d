"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention.py``.  The kernel
(``csrc/paged_attention.cu``) replaces the Pallas ``paged_attention``;
its source note says what bounds it on the H100 and how the design
answers.  :func:`paged_attention_ref` is the plain PyTorch version with
the reference oracle's semantics: the CPU path of the port and the
yardstick the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {"paged_attention_decode":
              (_P,) * 6 + (_I,) * 8 + (_F, _I, _P)}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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


def paged_attention_ref(q, k_pages, v_pages, page_table, valid_len, *,
                        window: int = 0, ring: bool = False):
    """Gather-based plain version (the reference oracle's math, in fp32)."""
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
    mask = ok & in_page
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask, probs, 0.0)   # fully-masked rows stay finite
    return torch.einsum("bhs,bshd->bhd", probs, v.float()).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, valid_len, *,
                    window: int = 0, ring: bool = False):
    """q: (B, H, D); k/v_pages: (P, page, KV, D) pool; page_table:
    (B, max_pages) int32 physical page ids, -1 padded; valid_len: (B,)
    int32 total tokens.  ``window > 0`` masks keys outside the last
    ``window`` positions; ``ring=True`` reads the table as a
    position-modular ring.  Returns (B, H, D) in q's dtype.

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
    if page_table.dtype != torch.int32 or page_table.shape[0] != b \
            or valid_len.dtype != torch.int32 or valid_len.shape != (b,):
        raise ValueError("paged_attention: page_table must be (B, maxp) "
                         "int32 and valid_len (B,) int32")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), \
        v_pages.contiguous()
    page_table, valid_len = page_table.contiguous(), valid_len.contiguous()
    out = torch.empty_like(q)
    lib = _build.library("paged_attention", _SIGNATURE)
    code = lib.paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        b, h, kvh, d, page, max_pages, int(window), int(bool(ring)),
        d ** -0.5, _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
