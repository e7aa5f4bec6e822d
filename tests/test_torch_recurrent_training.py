"""Training of the recurrent families -- RWKV-6 and Mamba-2/zamba2 -- in
the port against the JAX package's, on CPU.

The scan Functions' backward (``SSDScan``, ``WKV``) is held against
autograd through the plain versions; the whole model's loss and
gradients, and two train steps, against the reference's
``jax.value_and_grad`` and jitted step on bridged weights.  The reference
runs at ``scan_chunk=16``: at its default 128 its RWKV-6 chunk clamp
bites (``ROADMAP.md``, queue C).  Inputs come from numpy seeds; each test
states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.materializer import SINGLE_POD
from repro.core.materializer import Plan as JaxPlan
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import build_model
from repro.models.transformer import ImplConfig as JaxImplConfig
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100, Plan, materialize
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import rwkv6_scan, ssd_scan
from repro_torch.launch.train import train
from repro_torch.models.model import Model, init_params
from repro_torch.models.transformer import ImplConfig
from repro_torch.runtime import TorchExecutor
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step

# zamba2 at two pattern blocks (so the shared block runs twice), rwkv6 at
# two layers
LAYERS = {"zamba2-2.7b": 12, "rwkv6-7b": 2}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# The scan Functions: backward against autograd through the plain versions
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, h, s, p, n, decay):
    """fp32 (x, dt, a, b, c) and cotangents (dy, dstate); a is about
    ``-decay`` per token."""
    f = lambda *shape, scale=1.0: torch.tensor(       # noqa: E731
        rng.standard_normal(shape) * scale, dtype=torch.float32)
    dt = torch.nn.functional.softplus(f(b, h, s))
    a = -decay * torch.exp(f(b, h, s, scale=0.1)) * dt / dt.mean()
    ins = (f(b, h, s, p), dt, a, f(b, s, n, scale=0.5), f(b, s, n, scale=0.5))
    return ins, (f(b, h, s, p), f(b, h, p, n))


def _wkv_inputs(rng, b, h, s, hd, decay):
    """fp32 (r, k, v, logw, u) and cotangents (do, dstate); logw is about
    ``-decay`` per token and channel."""
    f = lambda *shape, scale=1.0: torch.tensor(       # noqa: E731
        rng.standard_normal(shape) * scale, dtype=torch.float32)
    logw = -torch.exp(f(b, h, s, hd, scale=0.5) + np.log(decay))
    ins = (f(b, h, s, hd, scale=0.5), f(b, h, s, hd, scale=0.5),
           f(b, h, s, hd, scale=0.5), logw, f(h, hd, scale=0.3))
    return ins, (f(b, h, s, hd), f(b, h, hd, hd))


SCANS = {   # Function, plain version, backward, inputs, a prefix of them
    "ssd": (ssd_scan.SSDScan, ssd_scan.ssd_scan_ref, ssd_scan.ssd_scan_bwd,
            lambda rng, s, decay: _ssd_inputs(rng, 2, 3, s, 8, 4, decay),
            lambda x, dt, a, b, c, s: (x[:, :, :s], dt[:, :, :s],
                                       a[:, :, :s], b[:, :s], c[:, :s])),
    "wkv": (rwkv6_scan.WKV, rwkv6_scan.rwkv6_wkv_ref,
            rwkv6_scan.rwkv6_wkv_bwd,
            lambda rng, s, decay: _wkv_inputs(rng, 2, 3, s, 8, decay),
            lambda r, k, v, logw, u, s: (r[:, :, :s], k[:, :, :s],
                                         v[:, :, :s], logw[:, :, :s], u)),
}


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("s,decay,final", [
    (150, 0.5, True),     # ragged over three chunks of 64
    (150, 4.0, False),    # a chunk's log-decay passes -30 within 8 tokens
    (64, 1.0, True),      # one whole chunk
    (5, 1.0, True),       # shorter than a chunk
])
def test_scan_function_backward_matches_autograd(scan, s, decay, final):
    """The Function's gradients (all five inputs) against autograd through
    the plain version, fp32 on both sides, with and without a gradient of
    the final state.  The two differ by fp32 summation order: the backward
    works in chunks of 64 from the chunk-start states, the plain version
    in chunks of 128, each summing up to a few hundred products (~1e-5 of
    the norm at fp32's 6e-8 rounding).  Limit: 5e-5 relative norm per
    input."""
    fn, ref, _, make, _ = SCANS[scan]
    ins, (dout, dstate) = make(np.random.default_rng(s), s, decay)

    def grads(f):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        out, state = f(*leaves)
        loss = (out * dout).sum() + ((state * dstate).sum() if final else 0)
        return torch.autograd.grad(loss, leaves)

    for got, want in zip(grads(fn.apply), grads(ref)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.isfinite(got).all()
        assert _rel(got, want.numpy()) <= 5e-5


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_backward_from_given_chunk_states(scan):
    """The backward from chunk-start states it is given (the kernel's on
    CUDA) against the one that computes them: given here as the plain
    version's final states of the 0-, 64-, 128- and 192-token prefixes of
    200 tokens.  fp32; 1e-5 relative norm per input."""
    _, ref, bwd, make, prefix = SCANS[scan]
    ins, (dout, dstate) = make(np.random.default_rng(1), 200, 1.0)
    states = torch.stack([ref(*prefix(*ins, s0))[1]
                          for s0 in range(0, 200, 64)], dim=2)
    given = bwd(*ins, states, dout, dstate)
    computed = bwd(*ins, None, dout, dstate)
    for a, b in zip(given, computed):
        assert _rel(a, b.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# The model: loss and gradients against the reference
# ---------------------------------------------------------------------------

def _cfgs(arch):
    extra = dict(num_layers=LAYERS[arch])
    return (jax_reduced(jax_get_config(arch), **extra),
            reduced_config(get_config(arch), **extra))


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


@pytest.fixture(scope="module")
def reference():
    """(arch, dtype) -> the reduced configs, the bridged weights' host
    arrays, one batch, and the reference's loss and gradient leaves (with
    their key paths) on those weights in that dtype, each computed once
    for the module."""
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            jcfg, tcfg = _cfgs(arch)
            jparams = _jax_params(jcfg)        # bf16, the models' dtype
            if dtype == "float32":
                jparams = jax.tree.map(lambda a: a.astype(np.float32),
                                       jparams)
            nb, tb = _batch(tcfg)
            jmodel = build_model(jcfg, JaxImplConfig(
                remat="none", attn_impl="naive", scan_chunk=16))
            jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
            jloss, jgrads = jax.value_and_grad(
                lambda p: jmodel.loss_fn(p, jbatch)[0])(
                    jax.tree.map(jnp.asarray, jparams))
            flat = [(jax.tree_util.keystr(path), np.asarray(g, np.float32))
                    for path, g in jax.tree_util.tree_flatten_with_path(
                        jgrads)[0]]
            memo[arch, dtype] = (tcfg, jparams, tb, float(jloss), flat)
        return memo[arch, dtype]

    return get


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_loss_and_grads_match_reference(reference, arch, dtype):
    """Reduced rwkv6-7b (2 layers) and zamba2-2.7b (two pattern blocks, the
    shared block applied twice), bridged weights, one ``SyntheticLM``
    batch (seq 64, batch 8): the port's ``loss_fn`` + ``backward()``
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` (naive
    attention, no remat, ``scan_chunk=16``), every leaf -- the shared
    block's included -- compared.

    bf16 (the models' dtype): loss within 1e-3 relative, each gradient
    leaf within 2e-2 relative norm of the reference's.  Where the
    reference's own bf16 gradient lies further than that from its fp32
    gradient at the same weights (rwkv6's token-shift mixes ``mu`` and
    ``mu_c``, whose gradients are bf16 sums over every token), the port's
    must lie no further from that fp32 gradient than the reference's
    does.  fp32 weights: both compute the same function in fp32, in
    another summation order; loss within 1e-5 relative, each leaf within
    1e-4 relative norm."""
    tcfg, jparams, tb, jloss, flat_j = reference(arch, dtype)
    model = Model(tcfg, ImplConfig(remat="none"))
    loss, grads = _port_grads(model, params_from_jax(jparams, tcfg, "cpu"),
                              tb)
    loss_tol, grad_tol = (1e-3, 2e-2) if dtype == "bfloat16" else (1e-5, 1e-4)
    assert abs(float(loss) - jloss) <= loss_tol * abs(jloss)
    flat_t = topt.leaves(grads)
    assert len(flat_j) == len(flat_t)
    assert (any("shared_attn" in k for k, _ in flat_j)
            == (arch == "zamba2-2.7b"))
    exact = None
    for (key, gj), gt in zip(flat_j, flat_t):
        assert gt.dtype == getattr(torch, dtype)
        assert float(np.abs(gj).max()) > 0
        err = _rel(gt, gj)
        if err <= grad_tol:
            continue
        assert dtype == "bfloat16", (key, err)
        if exact is None:                  # the fp32 gradient at the weights
            exact = dict(reference(arch, "float32")[4])
        ref_err = _rel(torch.from_numpy(gj), exact[key])
        assert ref_err > grad_tol and _rel(gt, exact[key]) <= ref_err, \
            (key, err, ref_err)


def test_zamba2_train_step_matches_reference():
    """Two steps of microbatch 2 with int8 gradient fake-quantization on
    reduced zamba2-2.7b (two pattern blocks) with bridged weights and the
    same batches: the port's eager step against the reference's jitted
    one (``scan_chunk=16``).  Losses within 1e-3 relative; the params
    within 1e-2 relative norm per leaf, as
    ``test_train_step_matches_reference`` holds tinyllama's.  The weights
    are fp32 here: zamba2's zero-initialized norm gains and conv bias
    hold values of ~0.02, against which Adam's first steps move each
    element by ~1e-3, so one bf16 rounding that flips an update's sign
    is ~5% of that element (bf16 weights measured 1.03e-2 on one gain
    leaf); ``test_loss_and_grads_match_reference`` holds the bf16
    gradients."""
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    jparams = jax.tree.map(lambda a: a.astype(np.float32),
                           _jax_params(jcfg, seed=1))
    ocfg = dict(warmup_steps=1, peak_lr=1e-3)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none", scan_chunk=16))
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
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= 1e-3 * abs(float(jm["loss"]))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            topt.leaves(tp)):
        err = _rel(a, np.asarray(b, np.float32))
        assert err <= 1e-2, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# remat: "dots" and "full" against "none"
# ---------------------------------------------------------------------------

class _CountMatmuls(TorchDispatchMode):
    """Counts ``aten.mm`` calls (the matmuls without batch dims that
    ``remat="dots"`` saves) while active."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_remat_policies_give_the_same_gradients(arch):
    """``remat="dots"`` and ``"full"`` against ``"none"`` on reduced
    zamba2-2.7b and rwkv6-7b: bit-equal loss and gradients on the CPU (the
    recompute runs the same ops on the same inputs in the same order).
    The backward runs as many matmuls under ``"dots"`` as under
    ``"none"`` -- no saved matmul runs again -- and more under
    ``"full"``, which recomputes them."""
    _, tcfg = _cfgs(arch)
    params = init_params(tcfg, 3, "cpu")
    _, batch = _batch(tcfg, batch=4)
    out = {}
    for remat in ("none", "dots", "full"):
        tracked = topt.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
        loss, _ = Model(tcfg, ImplConfig(remat=remat)).loss_fn(tracked, batch)
        with _CountMatmuls() as count:
            grads = torch.autograd.grad(loss, topt.leaves(tracked))
        out[remat] = (loss.detach(), grads, count.mm)
    base_loss, base, base_mm = out["none"]
    for remat in ("dots", "full"):
        loss, grads, _ = out[remat]
        assert torch.equal(loss, base_loss), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), remat
    assert out["dots"][2] == base_mm < out["full"][2]


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_train_zamba2_reduced_lowers_the_loss():
    """``train("zamba2-2.7b", reduced=True, device="cpu")`` through
    ``Cluster.submit``: 8 steps at lr 1e-2, the mean of the last steps'
    losses below the first ones'."""
    out = train("zamba2-2.7b", reduced=True, device="cpu", steps=8,
                opt_cfg=topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2),
                verbose=False)
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert out["model"].cfg.name == "zamba2-2.7b"
    assert "shared_attn" in out["params"]


def test_train_binds_a_dots_plan():
    """A ``ModelConfig`` (reduced zamba2-2.7b) with ``remat="dots"`` and 2
    microbatches as plan overrides, as the chip run passes them: the plan
    binds, the model runs under ``dots``, and 2 steps give finite
    losses."""
    cfg = reduced_config(get_config("zamba2-2.7b"), num_layers=12)
    out = train(cfg, shape=ShapeConfig("tiny", "train", 32, 4),
                overrides={"microbatch": 2, "remat": "dots"}, device="cpu",
                steps=2, opt_cfg=topt.OptimizerConfig(warmup_steps=1),
                verbose=False)
    assert out["model"].impl.remat == "dots" and out["model"].cfg == cfg
    assert (out["plan"].remat, out["plan"].microbatch) == ("dots", 2)
    assert all(np.isfinite([m["loss"] for m in out["metrics"]]))


def test_full_depth_rwkv6_is_refused_before_any_weights(monkeypatch):
    """rwkv6-7b at its full 32 layers, train seq 4096 x batch 8: no plan
    fits one card, so ``train`` raises before any weights are made.  The
    same config cut to 8 layers, as the chip run trains it, has a plan
    that fits (full remat, microbatch 4)."""
    made = []
    monkeypatch.setattr(TorchExecutor, "init_params",
                        lambda self, handle: made.append(handle))
    shape = ShapeConfig("train_4k_b8", "train", 4096, 8)
    with pytest.raises(RuntimeError, match="does not fit"):
        train("rwkv6-7b", shape=shape, device="cpu", steps=1, verbose=False)
    assert made == []
    cut = get_config("rwkv6-7b").scaled(num_layers=8)
    plan = materialize(cut, shape, H100,
                       overrides={"remat": "full", "microbatch": 4})
    assert plan.est_bytes_per_device < H100.hbm_per_device
