"""The plain mirrors of the redesigned K2 forward and K1, on CPU.

The bf16 forward kernel rounds p to bf16 before p.V over key tiles of
``FWD_BLOCK_K``; ``flash_attention_fwd_ref(..., operand_dtype=
torch.bfloat16, block_k=64)`` repeats that arithmetic and is held against
the Pallas forward (interpreted, as ``tests/test_kernels.py`` runs it).
The paged-decode kernel splits each lane's table into runs of
``pages_per_split`` entries and combines the partials;
``paged_attention_split_ref`` repeats that and is held against the JAX
oracle ``paged_attention_ref``.  Inputs are drawn with numpy from a seed;
each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (FWD_BLOCK_K,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_ref)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_split_ref,
                                                 split_pages)


def rel_norm(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _sdpa_order(q, k, v, causal, window, q_offset):
    """The plain forward as it stood before ``operand_dtype``: the
    reference ``sdpa``'s order of operations and roundings."""
    sq, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (d ** -0.5)
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    ok = torch.ones(sq, k.shape[2], dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    scores = torch.where(ok, scores, -1e30)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


# ---------------------------------------------------------------------------
# K2: the plain forward's default call is unchanged, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,q_offset,sk", [
    (True, 0, 0, 96), (False, 0, 0, 96), (True, 40, 0, 96), (True, 0, 32, 128)])
def test_fwd_ref_default_call_is_unchanged(dtype, causal, window, q_offset,
                                           sk):
    rng = np.random.default_rng(sk + window + q_offset)
    sq = 96

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    q, k, v = t(2, 4, sq, 32), t(2, 2, sk, 32), t(2, 2, sk, 32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _sdpa_order(q, k, v, causal, window, q_offset)
    for got in (flash_attention_fwd_ref(q, k, v, **kw),
                flash_attention_fwd_ref(q, k, v, operand_dtype=None,
                                        block_k=16, **kw),
                flash_attention_fwd(q, k, v, **kw)):   # the CPU wrapper
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# K2: the bf16-operand mirror against the Pallas forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,q_offset", [
    (2, 4, 2, 192, 192, 64, True, 0, 0),       # causal GQA
    (1, 4, 2, 192, 192, 32, True, 70, 0),      # sliding window
    (1, 4, 2, 128, 192, 64, True, 0, 64),      # q_offset
    (1, 2, 1, 128, 128, 80, True, 0, 0),       # head dim 80 (zamba2)
    (1, 2, 2, 128, 128, 16, False, 0, 0),      # non-causal
])
def test_fwd_ref_bf16_operands_matches_pallas(b, h, kvh, sq, sk, d, causal,
                                              window, q_offset):
    """bf16 inputs.  The mirror with ``operand_dtype=torch.bfloat16`` and
    the kernel's ``block_k`` lies within 1e-2 relative norm of the Pallas
    forward (interpreted, fp32 on the same values; measured ~2e-3 with the
    output's bf16 rounding), and, on fp32 copies, more than 1e-5 from the
    fp32 plain version, so the rounding of p is applied (measured ~1e-3).
    lse keeps fp32 accuracy: within 1e-5 of the Pallas lse.  The Pallas
    kernel takes Sq == Sk and no offset: the ``q_offset`` rows in front of
    the queries are zero queries, and only the real rows are compared."""
    assert FWD_BLOCK_K == 64
    rng = np.random.default_rng(sq + sk + d + window)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v = bf16((b, h, sq, d)), bf16((b, kvh, sk, d)), bf16((b, kvh, sk, d))
    pad = np.zeros((b, h, sk - sq, d), np.float32)
    qj = jnp.asarray(np.concatenate([pad, q.float().numpy()], axis=2))
    o_j, lse_j = jax_fwd(qj, jnp.asarray(k.float().numpy()),
                         jnp.asarray(v.float().numpy()), causal=causal,
                         window=window, block_q=64, block_k=64)
    o_j = np.asarray(o_j)[:, :, sk - sq:]
    lse_j = np.asarray(lse_j)[:, :, sk - sq:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    o, lse = flash_attention_fwd_ref(q, k, v, operand_dtype=torch.bfloat16,
                                     block_k=64, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert rel_norm(o.float(), o_j) <= 1e-2
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-6)

    q32, k32, v32 = q.float(), k.float(), v.float()
    o32, lse32 = flash_attention_fwd_ref(q32, k32, v32, **kw)
    o_r, lse_r = flash_attention_fwd_ref(q32, k32, v32,
                                         operand_dtype=torch.bfloat16,
                                         block_k=64, **kw)
    assert rel_norm(o_r, o32) > 1e-5
    assert rel_norm(o_r, o_j) <= 1e-2
    assert rel_norm(o32, o_j) <= 1e-5
    torch.testing.assert_close(lse_r, lse32, atol=1e-5, rtol=1e-6)


def test_rows_aligned_takes_no_copy_of_the_model_layouts():
    """The serving runner's chunked prefill attends over the gathered
    context pages concatenated in front of the chunk's K/V (``torch.cat``
    along the sequence of (1, S, KV, hd)); that layout, and the model's
    (B, S, H, hd) projections, reach the tensor-core kernels' ``cp.async``
    without a copy.  A row 4 elements off its 16-byte alignment is
    copied, with its values."""
    rng = np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q = bf16(1, 128, 32, 64).transpose(1, 2)
    k = torch.cat([bf16(1, 256, 4, 64), bf16(1, 128, 4, 64)],
                  dim=1).transpose(1, 2)
    v = torch.cat([bf16(1, 256, 4, 64), bf16(1, 128, 4, 64)],
                  dim=1).transpose(1, 2)
    assert all(a is w for a, w in zip(fa._rows_aligned(q, k, v), (q, k, v)))
    odd = bf16(1, 128, 4 * 64 + 4)[..., :4 * 64].unflatten(
        -1, (4, 64)).transpose(1, 2)
    (fixed,) = fa._rows_aligned(odd)
    assert fixed is not odd and torch.equal(fixed, odd)
    assert all(s % 8 == 0 for s in fixed.stride()[:3])


# ---------------------------------------------------------------------------
# K1: the split and combine against the JAX oracle
# ---------------------------------------------------------------------------

def _table(rng, b, pool, maxp, pages, page):
    """Lanes of ``pages[i]`` live entries (0: an all -1 lane) and valid
    lengths inside their last page."""
    table = np.full((b, maxp), -1, np.int32)
    vlen = np.ones(b, np.int32)
    ids = rng.permutation(pool)
    used = 0
    for i, n in enumerate(pages):
        table[i, :n] = ids[used:used + n]
        used += n
        if n:
            vlen[i] = n * page - int(rng.integers(0, page))
    return table, vlen


@pytest.mark.parametrize("pages_per_split", [1, 3, 8])
@pytest.mark.parametrize("window,ring", [(0, False), (40, False), (40, True)])
def test_paged_split_ref_matches_jax_oracle(pages_per_split, window, ring):
    """Lanes of 1, 4 and 8 live pages of 8 and an all -1 lane, so that
    splits past a lane's length, splits holding only -1 entries, and (with
    the window) splits whose tokens are all masked add nothing; fp32,
    within 2e-5 (summation order), and an all -1 lane is exactly 0."""
    rng = np.random.default_rng(pages_per_split * 10 + window + ring)
    b, h, kvh, d, pool, page, maxp = 4, 8, 2, 32, 24, 16, 8
    table, vlen = _table(rng, b, pool, maxp, [1, 4, 8, 0], page)
    if ring:
        vlen[:3] = [300, 70, 200]     # ring lanes wrap their 8 pages
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kvh, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, vlen)]
    got = paged_attention_split_ref(*args, window=window, ring=ring,
                                    pages_per_split=pages_per_split)
    want = jax_paged_ref(*(jnp.asarray(a) for a in (q, kp, vp, table, vlen)),
                         window=window, ring=ring)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert got[-1].abs().max().item() == 0.0
    # the CPU wrapper is the gather-based plain version, unchanged
    assert torch.equal(paged_attention(*args, window=window, ring=ring),
                       paged_attention_ref(*args, window=window, ring=ring))


@pytest.mark.parametrize("b,kvh,maxp", [(8, 4, 16), (64, 4, 16),
                                        (1, 4, 1024), (2, 8, 1)])
def test_split_pages_fills_the_sms(b, kvh, maxp):
    """The grid reaches 4 blocks an SM of a 132-SM card, or has one split
    per table entry; every entry is in exactly one split."""
    pps, splits = split_pages(b, kvh, maxp, 132)
    assert pps >= 1 and (splits - 1) * pps < maxp <= splits * pps
    assert b * kvh * splits >= 4 * 132 or splits == maxp
