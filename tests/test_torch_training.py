"""The port's training path against the JAX package's, on CPU.

The same inputs, drawn with numpy from a seed (or the same bridged
weights and ``SyntheticLM`` batches), go through the reference and the
port.  The reference's Pallas backward runs interpreted, as
``tests/test_kernels.py`` runs it; the port's wrappers take their plain
PyTorch versions for CPU tensors.  Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.materializer import SINGLE_POD
from repro.core.materializer import Plan as JaxPlan
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention import flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.models import build_model
from repro.models import layers as JL
from repro.models.transformer import ImplConfig as JaxImplConfig
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, MOE, RWKV6
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100, Plan
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_ref
from repro_torch.launch.train import train
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, init_params
from repro_torch.models.transformer import ImplConfig
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step

def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


# ---------------------------------------------------------------------------
# K5: the plain backward against the Pallas backward (interpreted), fp32,
# within 1e-4 abs (fp32 summation order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kvh,s,d,causal,window", [
    (1, 1, 64, 16, True, 0), (2, 2, 128, 32, True, 0),
    (1, 4, 128, 64, True, 48), (2, 1, 128, 16, False, 0),
    (1, 2, 64, 64, True, 16), (2, 4, 64, 32, False, 0),
])
def test_flash_attention_bwd_ref_matches_pallas(b, kvh, s, d, causal,
                                                window):
    h = 4
    rng = np.random.default_rng(b * 1000 + kvh * 100 + s + d + window)
    q, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, kvh, s, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    o, lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    want = jax_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                   jnp.asarray(do), **kw)
    args = (t32(q), t32(k), t32(v), t32(o), t32(lse), t32(do))
    got = flash_attention_bwd_ref(*args, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    # the CPU wrappers are the plain versions, pass by pass
    for g, w in zip(flash_attention_bwd(*args, causal=causal, window=window),
                    got):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K5 with bf16 operands: the plain versions round p and ds where the bf16
# tensor-core kernels do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,q_offset", [
    (2, 4, 2, 192, 192, 64, True, 0, 0),       # causal GQA
    (1, 2, 2, 128, 128, 16, False, 0, 0),      # non-causal, head dim 16
    (1, 8, 2, 256, 256, 64, True, 100, 0),     # sliding window
    (1, 4, 2, 128, 192, 128, True, 0, 64),     # q_offset, head dim 128
])
def test_flash_attention_bwd_ref_bf16_operands(b, h, kvh, sq, sk, d, causal,
                                               window, q_offset):
    """bf16 inputs.  The plain backward with ``operand_dtype=torch.bfloat16``
    lies within 1e-2 relative norm of the fp32 plain version and of the
    Pallas backward (interpreted, fp32 on the same values), and more than
    1e-4 from the fp32 plain version, so the rounding is applied (measured
    ~2.6e-3); ``operand_dtype=None`` is the default call, bit for bit.
    The Pallas kernels take Sq == Sk and no offset: the ``q_offset``
    rows before the queries are zero queries with zero dO, which add
    nothing to dK or dV."""
    rng = np.random.default_rng(sq + sk + d + window)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, do = bf16((b, h, sq, d)), bf16((b, h, sq, d))
    k, v = bf16((b, kvh, sk, d)), bf16((b, kvh, sk, d))
    pad = np.zeros((b, h, sk - sq, d), np.float32)

    def padded(t):
        return jnp.asarray(np.concatenate([pad, t.float().numpy()], axis=2))

    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    kj, vj = jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy())
    o_j, lse_j = jax_fwd(padded(q), kj, vj, **kw)
    o = t32(np.asarray(o_j)[:, :, sk - sq:]).to(torch.bfloat16)
    lse = t32(np.asarray(lse_j)[:, :, sk - sq:])
    pallas = jax_bwd(padded(q), kj, vj, padded(o), lse_j, padded(do), **kw)
    pallas = (np.asarray(pallas[0])[:, :, sk - sq:],) + tuple(pallas[1:])

    args = (q, k, v, o, lse, do)
    opts = dict(causal=causal, window=window, q_offset=q_offset)
    fp32 = flash_attention_bwd_ref(*args, **opts)
    rounded = flash_attention_bwd_ref(*args, operand_dtype=torch.bfloat16,
                                      **opts)
    for got, want, ref in zip(rounded, fp32, pallas):
        assert got.dtype == torch.bfloat16
        assert 1e-4 < rel_err(got, want.float().numpy()) <= 1e-2
        assert rel_err(got, ref) <= 1e-2
    unrounded = flash_attention_bwd_ref(*args, operand_dtype=None, **opts)
    assert all(torch.equal(a, w) for a, w in zip(unrounded, fp32))


@pytest.mark.parametrize("kvh,sq,sk,causal,window,q_offset", [
    (2, 96, 96, True, 0, 0), (1, 80, 80, True, 24, 0),
    (4, 48, 112, True, 0, 64), (2, 40, 40, False, 0, 0)])
def test_flash_attention_function_cpu_matches_autograd(kvh, sq, sk, causal,
                                                       window, q_offset):
    """``FlashAttention`` (plain forward, the backward passes' plain
    versions on CPU) against autograd through the plain forward, fp32,
    within 2e-5: one formula from lse, the other softmax's own backward."""
    rng = np.random.default_rng(sq + sk + window)
    q = t32(rng.standard_normal((2, 4, sq, 32)))
    k, v = (t32(rng.standard_normal((2, kvh, sk, 32))) for _ in range(2))
    do = t32(rng.standard_normal((2, 4, sq, 32)))
    opts = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttention.apply(*ins, causal, window, q_offset)
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_ref, _ = flash_attention_fwd_ref(*ref, **opts)
    assert torch.equal(out, o_ref)
    want = torch.autograd.grad(o_ref, ref, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_flash_attention_bwd_wrappers_refuse_unsupported_shapes():
    """Validation happens before any launch: checked on meta tensors."""
    q = torch.empty(1, 4, 128, 24, device="meta")
    k = torch.empty(1, 2, 128, 24, device="meta")
    lse = torch.empty(1, 4, 128, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd_dq(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd_dkv(q, k, k, lse, lse, q)
    q = torch.empty(1, 4, 128, 32, device="meta")
    k = torch.empty(1, 2, 128, 32, device="meta")
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd_dq(q, k, k, q[:, :2], lse, q)


def test_flash_attention_bwd_copies_only_unaligned_bf16_rows():
    """The bf16 backward kernels load rows by 16-byte ``cp.async``: the
    wrappers pass the model's layouts through and copy a bf16 tensor whose
    base or (batch, head, sequence) stride breaks the alignment; fp32
    tensors, which take the SIMT kernels, are never copied."""
    model = torch.zeros(2, 64, 4, 32, dtype=torch.bfloat16).transpose(1, 2)
    wide = torch.zeros(2, 64, 4 * 32 + 4, dtype=torch.bfloat16)
    strided = wide[..., :128].unflatten(-1, (4, 32)).transpose(1, 2)
    offset = torch.zeros(2 * 4 * 64 * 32 + 1, dtype=torch.bfloat16)[1:] \
        .view(2, 4, 64, 32)
    fp32 = torch.zeros(2, 64, 4 * 32 + 1)[..., :128].unflatten(
        -1, (4, 32)).transpose(1, 2)
    out = fa._rows_aligned(model, strided, offset, fp32)
    assert out[0] is model and out[3] is fp32
    for t, src in zip(out[1:3], (strided, offset)):
        assert t is not src and t.is_contiguous() and torch.equal(t, src)
        assert t.data_ptr() % 16 == 0


# ---------------------------------------------------------------------------
# K3's autograd Function and the loss function's pieces
# ---------------------------------------------------------------------------

def test_rmsnorm_function_matches_autograd_and_reference():
    """``RMSNorm`` on CPU (plain forward, closed-form backward) against
    autograd through the plain forward, and its gain gradient against
    ``jax.grad`` of the reference's ``rms_norm``: fp32, within 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    g = (rng.standard_normal(48) * 0.1).astype(np.float32)
    dy = rng.standard_normal((3, 5, 48)).astype(np.float32)
    xa, ga = t32(x).requires_grad_(True), t32(g).requires_grad_(True)
    got = torch.autograd.grad(RMSNorm.apply(xa, ga, 1e-6), (xa, ga), t32(dy))
    xr, gr = t32(x).requires_grad_(True), t32(g).requires_grad_(True)
    want = torch.autograd.grad(rmsnorm_ref(xr, gr), (xr, gr), t32(dy))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
    jx, jg = jax.grad(lambda x_, g_: jnp.sum(JL.rms_norm(x_, g_) * dy),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    """fp32 logits: within 1e-6 (a gather against a one-hot sum)."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = JL.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = TL.softmax_cross_entropy(
        t32(logits), torch.from_numpy(labels),
        None if mask is None else t32(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Loss and gradients of the whole model against the reference
# ---------------------------------------------------------------------------

def _cfgs(local: bool):
    extra = dict(num_layers=2)
    if local:
        extra.update(pattern=(ATTN_LOCAL, ATTN_GLOBAL), sliding_window=16)
    return (jax_reduced(jax_get_config("tinyllama-1.1b"), **extra),
            reduced_config(get_config("tinyllama-1.1b"), **extra))


def _jax_params(jcfg, seed=0):
    """The reference's init plus noise, so the (1+g) norm gains are not
    all zero."""
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.02).astype(a.dtype),
        jax.tree.map(np.asarray, jparams))


def _batch(cfg, step=0, seq=64, batch=8):
    b = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch)).batch_at(step)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(model, params, batch):
    tracked = topt.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    loss, _ = model.loss_fn(tracked, batch)
    loss.backward()
    return loss.detach(), topt.tree_map(lambda p: p.grad, tracked)


@pytest.mark.parametrize("local", [False, True])
def test_loss_and_grads_match_reference(local):
    """Reduced tinyllama-1.1b, 2 layers (global, or sliding-window 16 +
    global), bridged weights, one ``SyntheticLM`` batch (seq 64, batch 8):
    the port's ``loss_fn`` + ``backward()`` against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` (naive attention,
    no remat).  Loss within 1e-3 relative; each gradient leaf within 2e-2
    relative norm (bf16 weights and activations)."""
    jcfg, tcfg = _cfgs(local)
    jparams = _jax_params(jcfg)
    nb, tb = _batch(tcfg)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none", attn_impl="naive"))
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jbatch)[0])(
            jax.tree.map(jnp.asarray, jparams))
    model = Model(tcfg, ImplConfig(remat="none"))
    loss, grads = _port_grads(model, params_from_jax(jparams, tcfg, "cpu"),
                              tb)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_t = topt.leaves(grads)
    assert len(flat_j) == len(flat_t)
    for (path, gj), gt in zip(flat_j, flat_t):
        assert gt.dtype == torch.bfloat16
        err = rel_err(gt, np.asarray(gj, np.float32))
        assert err <= 2e-2, (jax.tree_util.keystr(path), err)


def test_remat_and_loss_chunk_do_not_change_the_gradients():
    """``remat="full"`` recomputes each block in the backward and
    ``loss_chunk`` streams the CE over sequence chunks: the same loss and
    gradients as ``"none"`` and one chunk, up to fp32 summation order of
    the CE (1e-6 relative); the remat gradients are bit-equal."""
    _, tcfg = _cfgs(False)
    params = init_params(tcfg, 3, "cpu")
    _, batch = _batch(tcfg, seq=64)
    base_loss, base = _port_grads(Model(tcfg, ImplConfig(remat="none")),
                                  params, batch)
    loss, grads = _port_grads(Model(tcfg, ImplConfig(remat="full")), params,
                              batch)
    assert torch.equal(loss, base_loss)
    for a, b in zip(topt.leaves(grads), topt.leaves(base)):
        assert torch.equal(a, b)
    loss, grads = _port_grads(
        Model(tcfg, ImplConfig(remat="full", loss_chunk=16)), params, batch)
    np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6)
    for a, b in zip(topt.leaves(grads), topt.leaves(base)):
        assert rel_err(a, b.float().numpy()) <= 1e-2


def test_unported_training_paths_raise():
    """What later slices bring raises and names its slice."""
    _, tcfg = _cfgs(False)
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(ValueError, match="later slice"):
        T._remat(lambda x: x, "dots")
    with pytest.raises(ValueError, match="RWKV-6"):
        T.apply_block_train(tcfg, RWKV6, {}, x)
    with pytest.raises(ValueError, match="MoE"):
        T.apply_block_train(tcfg, MOE, {}, x)


# ---------------------------------------------------------------------------
# Optimizer and train step against the reference
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    """fp32 on both sides: within 1e-6 relative, across warmup and decay."""
    cfg = dict(warmup_steps=10, decay_steps=100)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    for step in range(0, 130, 3):
        want = float(jopt.lr_at(jcfg, jnp.asarray(step)))
        assert abs(topt.lr_at(tcfg, step) - want) <= 1e-6 * want + 1e-12


@pytest.mark.parametrize("count", [0, 4, 9, 30, 120])
@pytest.mark.parametrize("grad_scale", [1.0, 0.01])
def test_adamw_update_matches_reference(count, grad_scale):
    """One update from the same numpy grads and state, at counts across
    warmup, the warmup boundary and the cosine decay, with clipping on
    (norm ~11) and off (norm ~0.1): m, v, master and the metrics within
    1e-6 (fp32), the bf16 params equal."""
    cfg = dict(warmup_steps=10, decay_steps=100, peak_lr=1e-2)
    rng = np.random.default_rng(count)
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4)}}

    def tree(fn):
        return jax.tree.map(lambda s: fn(s), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))

    g = tree(lambda s: (rng.standard_normal(s) * grad_scale)
             .astype(np.float32))
    state = {"m": tree(lambda s: rng.standard_normal(s).astype(np.float32)
                       * 0.01),
             "v": tree(lambda s: rng.random(s).astype(np.float32) * 1e-4),
             "master": tree(lambda s: rng.standard_normal(s)
                            .astype(np.float32) * 0.02)}
    jp, jstate, jm = jopt.adamw_update(
        jax.tree.map(jnp.asarray, g),
        dict(jax.tree.map(jnp.asarray, state),
             count=jnp.asarray(count, jnp.int32)),
        jopt.OptimizerConfig(**cfg))
    tstate = dict(topt.tree_map(t32, state),
                  count=torch.tensor(count, dtype=torch.int32))
    tp, tstate, tm = topt.adamw_update(topt.tree_map(t32, g), tstate,
                                       topt.OptimizerConfig(**cfg))
    assert int(tstate["count"]) == int(jstate["count"]) == count + 1
    for key in ("m", "v", "master"):
        for a, b in zip(topt.leaves(tstate[key]),
                        jax.tree.leaves(jstate[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    for a, b in zip(topt.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)


def test_train_step_matches_reference():
    """Two steps of microbatch 2 with int8 gradient fake-quantization, on
    reduced tinyllama-1.1b with bridged weights and the same batches
    (which the two data pipelines must produce identically): the port's
    eager step against the reference's jitted one.  Losses within 1e-3
    relative; the bf16 params within 1e-2 relative norm per leaf (a
    gradient that rounds across an int8 step moves its Adam update)."""
    jcfg, tcfg = _cfgs(False)
    jparams = _jax_params(jcfg, seed=1)
    ocfg = dict(warmup_steps=1, peak_lr=1e-3)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none"))
    jplan = JaxPlan("t", "train_4k", SINGLE_POD, microbatch=2, remat="none",
                    grad_compression="int8")
    jstep = jax.jit(jax_make_train_step(jmodel, jplan,
                                        jopt.OptimizerConfig(**ocfg)))
    tstep = make_train_step(Model(tcfg, ImplConfig(remat="none")),
                            Plan("t", "train_4k", H100, microbatch=2,
                                 grad_compression="int8"),
                            topt.OptimizerConfig(**ocfg))
    jp = jax.tree.map(jnp.asarray, jparams)
    jst = jopt.init_opt_state(jp)
    tp = params_from_jax(jparams, tcfg, "cpu")
    tst = topt.init_opt_state(tp)
    jdata = JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, 64, 8))
    tdata = SyntheticLM(DataConfig(tcfg.vocab_size, 64, 8))
    for step in range(2):
        nb = tdata.batch_at(step)
        for key, arr in jdata.batch_at(step).items():
            np.testing.assert_array_equal(nb[key], arr)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.from_numpy(v)
                                      for k, v in nb.items()})
        assert set(tm) == set(jm)
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= 1e-3 * abs(float(jm["loss"]))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            topt.leaves(tp)):
        err = rel_err(a, np.asarray(b, np.float32))
        assert err <= 1e-2, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_train_entry_point_lowers_the_loss():
    """As ``examples/train_lm.py`` asserts for the reference: the mean of
    the last steps' losses is below the mean of the first ones."""
    out = train("tinyllama-1.1b", reduced=True, device="cpu", steps=8,
                opt_cfg=topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2),
                verbose=False)
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert set(out["metrics"][0]) == {"ce", "aux", "loss", "grad_norm", "lr",
                                      "wall_s"}
    assert out["shape"].seq_len == 64 and out["shape"].global_batch == 8


def test_train_takes_a_config_a_shape_and_a_plan():
    """A ``ModelConfig``, a ``ShapeConfig`` with a cut batch and an
    explicit plan (overrides of the ladder's), as the chip smoke passes
    them: 2 microbatches under full remat."""
    from repro_torch.configs import ShapeConfig
    cfg = reduced_config(get_config("tinyllama-1.1b"), num_layers=2)
    out = train(cfg, shape=ShapeConfig("tiny", "train", 32, 4),
                overrides={"microbatch": 2, "remat": "full"},
                device="cpu", steps=2,
                opt_cfg=topt.OptimizerConfig(warmup_steps=1), verbose=False)
    assert out["shape"].name == "tiny" and len(out["metrics"]) == 2
    assert out["model"].impl.remat == "full" and out["model"].cfg == cfg
    assert (out["plan"].microbatch, out["plan"].mesh) == (2, H100)
