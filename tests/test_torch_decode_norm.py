"""The plain mirrors of the split K4 and the fused K3 backward, on CPU.

The decode-attention kernel cuts each lane's cache into splits of
``keys_per_split`` keys and combines the partial softmax states;
``decode_split_ref`` repeats that and is held against the Pallas
``decode_attention`` (interpreted, as ``tests/test_torch_dense.py`` runs
it, ``block_s=64``) and the reference oracle ``decode_attention_ref``.
The RMSNorm backward kernel sums dgain per program and then the partials
in order; ``rmsnorm_bwd_mirror`` repeats that and is held against
``jax.grad`` of the reference's ``rms_norm``.  The grid helpers
(``split_keys``, ``bwd_blocks``) are checked for what the kernels rely
on.  Inputs are drawn with numpy from a seed; each test
states its tolerance.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as JL
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels.decode_attention import (BLOCKS_PER_SM, SPLIT_UNIT,
                                                  decode_attention,
                                                  decode_attention_ref,
                                                  decode_split_ref,
                                                  split_keys)
from repro_torch.models import layers as TL

TOL = dict(atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# K4: the split and combine against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 80, 128])
def test_decode_split_ref_matches_pallas_and_oracle(g, d):
    """Lanes of valid length 0, 1, 100 and S+7, at splits of half a
    ``SPLIT_UNIT``, of one, of 100 keys (S not a whole number of them), one
    split, and a split longer than the cache; fp32, within
    2e-5 (summation order).  The Pallas kernel returns zeros for a lane of
    length 0 (its l clamp), as the split form must; the oracle, whose
    softmax over an all-masked row is uniform, is compared on the other
    lanes."""
    rng = np.random.default_rng(10 * g + d)
    b, kvh, s = 4, 2, 192
    h = g * kvh
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    vlen = np.asarray([0, s + 7, 1, 100], np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, vlen)]
    pallas = np.asarray(ops.decode_attention(*jargs, block_s=64))
    oracle = np.asarray(ref.decode_attention_ref(*jargs))
    targs = [torch.from_numpy(a) for a in (q, k, v, vlen)]
    for kps in (SPLIT_UNIT // 2, SPLIT_UNIT, 100, s, 1000):
        got = decode_split_ref(*targs, keys_per_split=kps).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, pallas, **TOL)
        np.testing.assert_allclose(got[1:], oracle[1:], **TOL)
        assert np.abs(got[0]).max() == 0.0
    # the CPU wrapper is the plain version, unchanged
    assert torch.equal(decode_attention(*targs),
                       decode_attention_ref(*targs))


def test_decode_split_ref_bf16_rounds_once():
    """bf16 inputs: the split form computes in fp32 and rounds its output
    once, so it is within one bf16 ulp (2^-7 relative, 1e-4 near zero) of
    the oracle on the same bf16 values in fp32."""
    rng = np.random.default_rng(5)
    b, h, kvh, s, d = 3, 32, 32, 300, 80          # zamba2's G = 1, D = 80
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(torch.bfloat16) for sh in ((b, h, d), (b, kvh, s, d),
                                              (b, kvh, s, d)))
    vlen = torch.tensor([300, 57, 1], dtype=torch.int32)
    got = decode_split_ref(q, k, v, vlen, keys_per_split=64)
    want = decode_split_ref(q.float(), k.float(), v.float(), vlen, s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("b,kvh,s", [(8, 32, 2048), (8, 4, 2048),
                                     (1, 1, 100), (2, 2, 1000),
                                     (64, 8, 4096), (3, 4, 129)])
@pytest.mark.parametrize("sms", [132, 16])
def test_split_keys_reaches_its_block_target(b, kvh, s, sms):
    """Splits are whole ``SPLIT_UNIT``s covering the cache once; the grid
    reaches ``BLOCKS_PER_SM`` blocks an SM or has one split per unit; and
    the split is a function of the shapes and the SM count alone (the
    valid lengths are never read on the host)."""
    assert list(inspect.signature(split_keys).parameters) == ["b", "kvh",
                                                              "s", "sms"]
    kps, splits = split_keys(b, kvh, s, sms)
    assert kps % SPLIT_UNIT == 0 and kps >= SPLIT_UNIT
    assert (splits - 1) * kps < s <= splits * kps
    assert b * kvh * splits >= BLOCKS_PER_SM * sms or kps == SPLIT_UNIT
    assert split_keys(b, kvh, s, sms) == (kps, splits)


def test_decode_attention_raises_on_what_the_kernel_does_not_take():
    """Off the CPU, the wrapper checks before it launches: a head dim the
    kernel lacks and mixed dtypes raise (meta tensors stand in for CUDA)."""
    q = torch.empty(2, 4, 96, device="meta")
    kv = torch.empty(2, 2, 64, 96, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, kv, kv, 10)
    q = torch.empty(2, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(2, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(q, kv, kv, 10)


# ---------------------------------------------------------------------------
# K3: the backward's decomposition against jax.grad of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [48, 2560, 5120])
@pytest.mark.parametrize("rows_per_program", [1, 8, 16])
def test_rmsnorm_bwd_mirror_matches_jax_grad(d, rows_per_program):
    """37 rows (no multiple of the rows per program) of widths 48, 2560 and
    5120; fp32, within 1e-5 of ``jax.grad`` of the reference's
    ``rms_norm`` (as ``test_torch_training.py`` holds the Function)."""
    rng = np.random.default_rng(d + rows_per_program)
    x = rng.standard_normal((37, d)).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((37, d)).astype(np.float32)
    dx, dg = rms.rmsnorm_bwd_mirror(torch.from_numpy(dy), torch.from_numpy(x),
                                    torch.from_numpy(g), 1e-6,
                                    rows_per_program)
    jx, jg = jax.grad(lambda x_, g_: jnp.sum(JL.rms_norm(x_, g_) * dy),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def test_rmsnorm_function_backward_is_the_plain_version_on_cpu():
    """On CPU tensors ``RMSNorm``'s backward goes through ``rmsnorm_bwd``,
    which is ``rmsnorm_bwd_ref`` bit for bit; bf16 in, bf16 out."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32)) \
        .to(torch.bfloat16)
    g = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32)) \
        .to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32)) \
        .to(torch.bfloat16)
    xa, ga = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    got = torch.autograd.grad(rms.RMSNorm.apply(xa, ga, 1e-6), (xa, ga), dy)
    want = rms.rmsnorm_bwd_ref(dy, x, g)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w)
    assert all(torch.equal(a, w) for a, w in zip(rms.rmsnorm_bwd(dy, x, g),
                                                 want))
    # the model's norm on CPU stays the plain forward
    assert torch.equal(TL.rms_norm(x, g), rms.rmsnorm_ref(x, g))


def test_rmsnorm_wrappers_raise_off_the_cpu_on_what_they_do_not_take():
    """A tensor that is neither on the CPU nor on a CUDA device (meta)
    raises in both directions instead of falling back."""
    x = torch.empty(4, 64, device="meta")
    g = torch.empty(64, device="meta")
    with pytest.raises(ValueError):
        rms.rmsnorm(x, g)
    with pytest.raises(ValueError):
        rms.rmsnorm_bwd(x, x, g)


@pytest.mark.parametrize("rows,d", [(8, 2048), (8, 2560), (1000, 2560),
                                    (1000, 5120), (1000, 4096),
                                    (8192, 2048), (33, 128), (5, 48),
                                    (3, 100), (2, 7), (4, 2816)])
def test_rmsnorm_bwd_blocks_cover_the_rows(rows, d):
    """The backward's block holds the whole row; its programs take whole
    steps of ``block_r`` rows within ``TILE`` elements, together every row
    once, on a grid of at most ``BWD_PROGRAMS_PER_SM`` programs an SM."""
    sms = 132
    block_r, block_d, per = rms.bwd_blocks(rows, d, sms)
    assert block_d >= d and block_d & (block_d - 1) == 0
    assert block_r * block_d <= max(rms.TILE, block_d)
    assert per % block_r == 0
    programs = -(-rows // per)
    assert (programs - 1) * per < rows <= programs * per
    assert programs <= rms.BWD_PROGRAMS_PER_SM * sms
