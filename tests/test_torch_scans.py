"""The port's scan kernels (K6 RWKV-6 WKV, K7 Mamba-2 SSD) against the JAX
package's, on CPU.

The same inputs, drawn with numpy from a seed as ``tests/test_kernels.py``
draws them, go through the reference (the Pallas kernels interpreted on
CPU through ``repro.kernels.ops``, and the per-step oracles of
``repro.kernels.ref``) and through the port's wrappers, which take their
plain chunked versions for CPU tensors.  The plain versions' chunk length
(the module constant ``CHUNK``) is set to each case's chunk, so the sweep
takes the chunk boundaries and padded tails that ``test_kernels.py`` gives
the Pallas kernels.  Tolerance rtol = atol = 1e-4, as ``test_kernels.py``
holds the Pallas scans to their oracles.  Ragged lengths, which the Pallas
wrappers drop by integer division, are held against the oracles only.

The bf16 CUDA kernels' block decompositions, in plain PyTorch
(``ssd_scan_mirror``, ``rwkv6_wkv_mirror``), are held against the same
oracles at the same tolerance, decays that overflow a factorization
without reference points included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jrw
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.kernels import ssd_scan as tss
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as trw

TOL = dict(rtol=1e-4, atol=1e-4)


def ra(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(*arrays):
    """The same fp32 values as JAX arrays and as torch tensors."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _wkv_inputs(rng, b, h, s, hd, decay_shift=1.0):
    r, k, v = (ra(rng, b, h, s, hd, scale=0.5) for _ in range(3))
    logw = -np.exp(ra(rng, b, h, s, hd, scale=0.5) - decay_shift)
    u = ra(rng, h, hd, scale=0.3)
    return r, k, v, logw.astype(np.float32), u


def _ssd_inputs(rng, b, h, s, p, n):
    x = ra(rng, b, h, s, p, scale=0.5)
    dt = np.abs(ra(rng, b, h, s, scale=0.3)) + 0.1
    a = -np.abs(ra(rng, b, h, s, scale=0.3)) * dt
    bm, cm = ra(rng, b, s, n, scale=0.5), ra(rng, b, s, n, scale=0.5)
    return x, dt.astype(np.float32), a.astype(np.float32), bm, cm


# ---------------------------------------------------------------------------
# K6 rwkv6_wkv: the test_rwkv6_wkv sweep, then ragged lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,hd,chunk", [
    (1, 2, 64, 8, 16), (2, 3, 128, 16, 32), (1, 1, 96, 32, 32)])
def test_rwkv6_wkv_matches_reference(b, h, s, hd, chunk, monkeypatch):
    monkeypatch.setattr(trs, "CHUNK", chunk)
    rng = np.random.default_rng(s * hd)
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(
        *_wkv_inputs(rng, b, h, s, hd))
    o, st = rwkv6_wkv(tr, tk, tv, tw, tu)
    o_pl, st_pl = ops.rwkv6_wkv(jr, jk, jv, jw, ju, chunk=chunk)
    o_ref, st_ref = ref.rwkv6_wkv_ref(jr, jk, jv, jw, ju)
    for got, a, c in ((o, o_pl, o_ref), (st, st_pl, st_ref)):
        close(got, a)
        close(got, c)


@pytest.mark.parametrize("s,chunk", [(77, 16), (5, 128), (129, 128)])
def test_rwkv6_wkv_ragged_matches_oracle(s, chunk, monkeypatch):
    """Any length: the final state is the state after exactly S tokens."""
    monkeypatch.setattr(trs, "CHUNK", chunk)
    rng = np.random.default_rng(s)
    ins_j, ins_t = both(*_wkv_inputs(rng, 2, 2, s, 16))
    o, st = rwkv6_wkv(*ins_t)
    o_ref, st_ref = ref.rwkv6_wkv_ref(*ins_j)
    close(o, o_ref)
    close(st, st_ref)


def test_port_wkv_chunked_at_chunk_128_has_no_clamp_fault():
    """The port's ``wkv_chunked`` at the serving chunk (128) and the model's
    decay (logw about -1 per token) against the per-step oracle.  The
    reference's own ``wkv_chunked`` clamps a split of the pairwise decay at
    exp(+-30) and is far off on these inputs (asserted, so the inputs do
    reach the fault); the port computes the recurrence exactly."""
    rng = np.random.default_rng(11)
    b, s, h, hd = 1, 256, 2, 16
    r, k, v = (ra(rng, b, s, h, hd, scale=0.5) for _ in range(3))
    logw = -np.exp(ra(rng, b, s, h, hd, scale=0.1)).astype(np.float32)
    u = ra(rng, h, hd, scale=0.3)
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(r, k, v, logw, u)
    assert trs.CHUNK == 128
    o, st = trw.wkv_chunked(tr, tk, tv, tw, tu)
    tr_ = lambda t: t.transpose(0, 2, 1, 3)
    o_ref, st_ref = ref.rwkv6_wkv_ref(tr_(jr), tr_(jk), tr_(jv), tr_(jw), ju)
    close(o.transpose(1, 2), o_ref)
    close(st, st_ref)
    o_jax, _ = jrw.wkv_chunked(jr, jk, jv, jw, ju,
                               jnp.zeros((b, h, hd, hd), jnp.float32), 128)
    fault = float(np.abs(np.asarray(tr_(o_jax)) - np.asarray(o_ref)).max())
    assert fault > 1.0, f"the reference's clamp fault did not show ({fault})"


# ---------------------------------------------------------------------------
# K7 ssd_scan: the test_ssd_scan sweep, then ragged lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 64, 8, 4, 16), (2, 2, 128, 16, 8, 32)])
def test_ssd_scan_matches_reference(b, h, s, p, n, chunk, monkeypatch):
    monkeypatch.setattr(tss, "CHUNK", chunk)
    rng = np.random.default_rng(s * p)
    ins_j, ins_t = both(*_ssd_inputs(rng, b, h, s, p, n))
    y, st = ssd_scan(*ins_t)
    y_pl, st_pl = ops.ssd_scan(*ins_j, chunk=chunk)
    y_ref, st_ref = ref.ssd_ref(*ins_j)
    for got, a, c in ((y, y_pl, y_ref), (st, st_pl, st_ref)):
        close(got, a)
        close(got, c)


@pytest.mark.parametrize("s,chunk", [(77, 16), (3, 128), (200, 128)])
def test_ssd_scan_ragged_matches_oracle(s, chunk, monkeypatch):
    monkeypatch.setattr(tss, "CHUNK", chunk)
    rng = np.random.default_rng(s)
    ins_j, ins_t = both(*_ssd_inputs(rng, 2, 3, s, 8, 8))
    y, st = ssd_scan(*ins_t)
    y_ref, st_ref = ref.ssd_ref(*ins_j)
    close(y, y_ref)
    close(st, st_ref)


def test_port_ssd_chunked_matches_reference_model():
    """The model-level ``ssd_chunked`` ((B, S, H, P) layout, a from
    ``a_log``) against the reference's at the serving chunk."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 200, 2, 8, 4
    x = ra(rng, b, s, h, p, scale=0.5)
    dt = (np.abs(ra(rng, b, s, h, scale=0.3)) + 0.1).astype(np.float32)
    a_log = ra(rng, h, scale=0.2)
    bm, cm = ra(rng, b, s, n, scale=0.5), ra(rng, b, s, n, scale=0.5)
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = both(x, dt, a_log, bm, cm)
    y, st = tm2.ssd_chunked(tx, tdt, ta, tb, tc)
    y_ref, st_ref = jm2.ssd_chunked(jx, jdt, ja, jb, jc,
                                    jnp.zeros((b, h, p, n), jnp.float32), 128)
    close(y, y_ref)
    close(st, st_ref)


def test_cpu_scans_take_the_plain_versions_and_count_no_launch():
    from repro_torch.kernels.decode_attention import decode_attention
    before = (rwkv6_wkv.launches, ssd_scan.launches, decode_attention.launches)
    rng = np.random.default_rng(0)
    _, ins = both(*_wkv_inputs(rng, 1, 1, 9, 8))
    rwkv6_wkv(*ins)
    _, ins = both(*_ssd_inputs(rng, 1, 1, 9, 8, 4))
    ssd_scan(*ins)
    q = torch.randn(1, 2, 16)
    decode_attention(q, torch.randn(1, 1, 5, 16), torch.randn(1, 1, 5, 16), 3)
    assert (rwkv6_wkv.launches, ssd_scan.launches,
            decode_attention.launches) == before


# ---------------------------------------------------------------------------
# The bf16 kernels' block decompositions (plain mirrors) against the
# per-step oracles: chunks of 64 (K6 in sub-chunks of 16), ragged tails,
# and decays strong enough that a factorization without reference points
# overflows
# ---------------------------------------------------------------------------

def _strong_wkv(rng, b, h, s, hd, per_token):
    r, k, v, _, u = _wkv_inputs(rng, b, h, s, hd)
    logw = -per_token * np.exp(ra(rng, b, h, s, hd, scale=0.1))
    return r, k, v, logw.astype(np.float32), u


def _strong_ssd(rng, b, h, s, p, n, per_token):
    x, dt, _, bm, cm = _ssd_inputs(rng, b, h, s, p, n)
    a = -per_token * np.exp(ra(rng, b, h, s, scale=0.1))
    return x, dt, a.astype(np.float32), bm, cm


@pytest.mark.parametrize("b,h,s,hd,chunk,sub", [
    (1, 2, 1, 16, 64, 16), (1, 2, 63, 16, 64, 16), (2, 2, 64, 8, 64, 16),
    (1, 3, 65, 16, 64, 16), (2, 2, 200, 32, 64, 16), (1, 2, 77, 16, 32, 8)])
def test_wkv_mirror_matches_oracle(b, h, s, hd, chunk, sub):
    rng = np.random.default_rng(100 + s)
    ins_j, ins_t = both(*_wkv_inputs(rng, b, h, s, hd))
    o, st = trs.rwkv6_wkv_mirror(*ins_t, chunk=chunk, sub=sub)
    o_ref, st_ref = ref.rwkv6_wkv_ref(*ins_j)
    close(o, o_ref)
    close(st, st_ref)


@pytest.mark.parametrize("per_token,s", [(10.0, 64), (10.0, 150), (4.0, 130)])
def test_wkv_mirror_strong_decay_needs_reference_points(per_token, s):
    """At about -10 (or -4) per token a chunk's log-decay sum reaches ~-640
    (~-256), so exp(-csum) overflows fp32 and any factorization without
    reference points fails; the mirror's factors never exceed 1 and it
    stays exact."""
    rng = np.random.default_rng(7)
    ins_j, ins_t = both(*_strong_wkv(rng, 1, 2, s, 16, per_token))
    csum = ins_t[3][:, :, :trs.KERNEL_CHUNK].cumsum(2)
    assert torch.isinf(torch.exp(-csum)).any()
    o, st = trs.rwkv6_wkv_mirror(*ins_t)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    o_ref, st_ref = ref.rwkv6_wkv_ref(*ins_j)
    close(o, o_ref)
    close(st, st_ref)


@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 1, 8, 8, 64), (1, 2, 63, 16, 8, 64), (2, 2, 64, 8, 4, 64),
    (1, 3, 65, 8, 16, 64), (2, 2, 200, 32, 32, 64), (1, 2, 77, 8, 8, 16)])
def test_ssd_mirror_matches_oracle(b, h, s, p, n, chunk):
    rng = np.random.default_rng(200 + s)
    ins_j, ins_t = both(*_ssd_inputs(rng, b, h, s, p, n))
    y, st = tss.ssd_scan_mirror(*ins_t, chunk=chunk)
    y_ref, st_ref = ref.ssd_ref(*ins_j)
    close(y, y_ref)
    close(st, st_ref)


@pytest.mark.parametrize("per_token,s", [(10.0, 64), (10.0, 150), (4.0, 130)])
def test_ssd_mirror_strong_decay_needs_reference_points(per_token, s):
    """The SSD form at about -10 per token: exp(-csum) over one chunk
    overflows, the mirror's exponents are never above 0 and it is exact."""
    rng = np.random.default_rng(8)
    ins_j, ins_t = both(*_strong_ssd(rng, 2, 2, s, 8, 8, per_token))
    csum = ins_t[2][:, :, :tss.KERNEL_CHUNK].cumsum(2)
    assert torch.isinf(torch.exp(-csum)).any()
    y, st = tss.ssd_scan_mirror(*ins_t)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = ref.ssd_ref(*ins_j)
    close(y, y_ref)
    close(st, st_ref)
