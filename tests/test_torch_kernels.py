"""The port's kernel modules against the JAX package's kernels, on CPU.

The same inputs, drawn with numpy from a seed, go through the reference
(``repro.kernels``: the Pallas kernels interpreted on CPU as
``tests/test_kernels.py`` runs them, or their jnp oracles) and through
the port's wrappers, which take their plain PyTorch versions for CPU
tensors.  Tolerances: fp32 inputs 2e-5 (as ``test_kernels.py``); bf16
inputs 2e-2 -- the port's plain attention rounds scores and probs to bf16
as the reference ``sdpa`` does, while the Pallas kernels keep them in
fp32, so the two differ by those roundings.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro.models.attention import sdpa as jax_sdpa
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rmsnorm import rmsnorm

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return jnp.asarray(a), t
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# K3 rmsnorm: the test_rmsnorm sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(8, 64), (33, 128), (256, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(rows, d, dtype):
    rng = np.random.default_rng(rows * d)
    xj, xt = pair(rng.standard_normal((rows, d)), dtype)
    gj, gt = pair(rng.standard_normal(d) * 0.1)
    close(rmsnorm(xt, gt), ops.rmsnorm(xj, gj), dtype)


# ---------------------------------------------------------------------------
# K1 paged attention: the test_paged_attention and ring/window cases
# ---------------------------------------------------------------------------

def _paged_inputs(rng, b, h, kvh, d, pool, page, maxp, empty_lane=False):
    q = rng.standard_normal((b, h, d))
    kp = rng.standard_normal((pool, page, kvh, d))
    vp = rng.standard_normal((pool, page, kvh, d))
    table = np.full((b, maxp), -1, np.int32)
    vlen = np.ones(b, np.int32)
    for i in range(b):
        if empty_lane and i == b - 1:
            break                         # a padded decode lane: vlen 1
        n = int(rng.integers(1, maxp + 1))
        table[i, :n] = rng.choice(pool, size=n, replace=False)
        vlen[i] = n * page - int(rng.integers(0, page))
    return q, kp, vp, table, vlen


@pytest.mark.parametrize("b,h,kvh,d,pool,page,maxp,empty_lane", [
    (2, 4, 2, 32, 8, 64, 3, False), (1, 8, 8, 16, 12, 32, 5, False),
    (3, 6, 2, 64, 16, 64, 4, False), (3, 6, 2, 64, 16, 64, 4, True)])
def test_paged_attention_matches_reference(b, h, kvh, d, pool, page, maxp,
                                           empty_lane):
    rng = np.random.default_rng(pool * page + empty_lane)
    q, kp, vp, table, vlen = _paged_inputs(rng, b + empty_lane, h, kvh, d,
                                           pool, page, maxp, empty_lane)
    (qj, qt), (kj, kt), (vj, vt) = pair(q), pair(kp), pair(vp)
    got = paged_attention(qt, kt, vt, torch.from_numpy(table),
                          torch.from_numpy(vlen))
    want = jax_paged(qj, kj, vj, jnp.asarray(table), jnp.asarray(vlen))
    close(got, want, "float32")
    if empty_lane:
        assert got[-1].abs().max().item() == 0.0, \
            "an all -1 lane must return zeros, not NaN"


@pytest.mark.parametrize("pos_last,ring", [
    (0, True), (5, True), (23, True), (24, True), (37, True), (100, True),
    (37, False)])
def test_paged_attention_ring_window_matches_reference(pos_last, ring):
    """The test_paged_attention_ring_window construction: each token
    written at its ring slot, last write wins (ring=True); the same pages
    read as a linear table with the window only (ring=False)."""
    rng = np.random.default_rng(pos_last)
    page, ring_pages, kvh, h, d, window, pool = 8, 3, 2, 4, 16, 20, 10
    ring_tokens = ring_pages * page
    vlen = pos_last + 1
    keys = rng.standard_normal((vlen, kvh, d))
    vals = rng.standard_normal((vlen, kvh, d))
    kp = np.zeros((pool, page, kvh, d))
    vp = np.zeros((pool, page, kvh, d))
    ids = [7, 2, 5][:min(ring_pages, -(-vlen // page))]
    table = np.full((1, ring_pages), -1, np.int32)
    table[0, :len(ids)] = ids
    for p in range(vlen):
        pg, off = divmod(p % ring_tokens, page)
        if pg < len(ids):
            kp[ids[pg], off] = keys[p]
            vp[ids[pg], off] = vals[p]
    if not ring:
        vlen = min(vlen, len(ids) * page)
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng.standard_normal((1, h, d))),
                                    pair(kp), pair(vp))
    got = paged_attention(qt, kt, vt, torch.from_numpy(table),
                          torch.tensor([vlen], dtype=torch.int32),
                          window=window, ring=ring)
    args = (qj, kj, vj, jnp.asarray(table), jnp.asarray([vlen]))
    close(got, jax_paged(*args, window=window, ring=ring), "float32")
    close(got, jax_paged_ref(*args, window=window, ring=ring), "float32")


def test_paged_attention_bf16_matches_reference():
    rng = np.random.default_rng(3)
    q, kp, vp, table, vlen = _paged_inputs(rng, 3, 8, 2, 64, 12, 128, 3,
                                           empty_lane=True)
    (qj, qt), (kj, kt), (vj, vt) = (pair(q, "bfloat16"), pair(kp, "bfloat16"),
                                    pair(vp, "bfloat16"))
    got = paged_attention(qt, kt, vt, torch.from_numpy(table),
                          torch.from_numpy(vlen))
    assert got.dtype == torch.bfloat16
    close(got, jax_paged_ref(qj, kj, vj, jnp.asarray(table),
                             jnp.asarray(vlen)), "bfloat16")


# ---------------------------------------------------------------------------
# K2 flash attention forward: o and lse, causal / windowed / q_offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,s,d", [
    (1, 8, 1, 128, 16), (2, 2, 2, 192, 48)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_fwd_matches_reference(b, h, kvh, s, d, causal,
                                               window):
    rng = np.random.default_rng(s * d + window)
    (qj, qt), (kj, kt), (vj, vt) = (pair(rng.standard_normal((b, h, s, d))),
                                    pair(rng.standard_normal((b, kvh, s, d))),
                                    pair(rng.standard_normal((b, kvh, s, d))))
    o, lse = flash_attention_fwd(qt, kt, vt, causal=causal, window=window)
    o_ref, lse_ref = jax_flash(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64)
    close(o, o_ref, "float32")
    close(lse, lse_ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fwd_bf16_and_fp32_vs_kernel(dtype):
    rng = np.random.default_rng(11)
    b, h, kvh, s, d = 1, 4, 2, 128, 64
    (qj, qt), (kj, kt), (vj, vt) = (
        pair(rng.standard_normal((b, h, s, d)), dtype),
        pair(rng.standard_normal((b, kvh, s, d)), dtype),
        pair(rng.standard_normal((b, kvh, s, d)), dtype))
    o, lse = flash_attention_fwd(qt, kt, vt, causal=True)
    o_ref, lse_ref = jax_flash(qj, kj, vj, causal=True, block_q=64,
                               block_k=64)
    assert o.dtype == TORCH[dtype]
    close(o, o_ref, dtype)
    close(lse, lse_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx_pages,ctx_w,chunk_pages", [(1, 1, 2), (3, 4, 1)])
def test_flash_attention_q_offset_matches_chunk_sdpa(dtype, ctx_pages, ctx_w,
                                                     chunk_pages):
    """The chunked-prefill case: the reference's ``_chunk_fn`` pads the
    context to ``ctx_w`` pages (a power of two) and masks the padding with
    ``k_valid``; the port attends over exactly the ``ctx_pages`` real
    pages with ``q_offset`` = the chunk's start.  Masked keys add exactly
    0, so the two agree."""
    page, h, kvh, d = 16, 4, 2, 16
    rng = np.random.default_rng(ctx_pages * 10 + chunk_pages)
    s, base = chunk_pages * page, ctx_pages * page
    q = rng.standard_normal((1, s, h, d))
    k_ctx = rng.standard_normal((1, ctx_pages * page, kvh, d))
    v_ctx = rng.standard_normal((1, ctx_pages * page, kvh, d))
    k_new = rng.standard_normal((1, s, kvh, d))
    v_new = rng.standard_normal((1, s, kvh, d))
    pad = np.zeros((1, (ctx_w - ctx_pages) * page, kvh, d))
    k_cat = np.concatenate([k_ctx, pad, k_new], axis=1)
    v_cat = np.concatenate([v_ctx, pad, v_new], axis=1)
    positions = base + jnp.arange(s)
    k_pos = jnp.concatenate([jnp.arange(ctx_w * page), positions])
    ctx_table = jnp.asarray([0] * ctx_pages + [-1] * (ctx_w - ctx_pages))
    k_valid = jnp.concatenate([jnp.repeat(ctx_table >= 0, page),
                               jnp.ones(s, bool)])
    want = jax_sdpa(pair(q, dtype)[0], pair(k_cat, dtype)[0],
                    pair(v_cat, dtype)[0], causal=True,
                    q_positions=positions, k_positions=k_pos,
                    k_valid=k_valid)
    k_port = np.concatenate([k_ctx, k_new], axis=1)
    v_port = np.concatenate([v_ctx, v_new], axis=1)
    o, _ = flash_attention_fwd(pair(q, dtype)[1].transpose(1, 2),
                               pair(k_port, dtype)[1].transpose(1, 2),
                               pair(v_port, dtype)[1].transpose(1, 2),
                               causal=True, q_offset=base)
    close(o.transpose(1, 2), want, dtype)


def test_cuda_wrappers_refuse_unsupported_shapes():
    """Shape validation happens before any launch, so it is checked on
    meta tensors here (a CUDA tensor would launch the kernel)."""
    q = torch.empty(1, 4, 128, 24, device="meta")
    k = torch.empty(1, 2, 128, 24, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, k, k)
    qp = torch.empty(2, 4, 24, device="meta")
    pages = torch.empty(4, 128, 2, 24, device="meta")
    with pytest.raises(ValueError):
        paged_attention(qp, pages, pages,
                        torch.empty(2, 3, dtype=torch.int32, device="meta"),
                        torch.empty(2, dtype=torch.int32, device="meta"))
