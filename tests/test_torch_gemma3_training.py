"""Training gemma3-12b in the port against the JAX package's, on CPU.

Reduced gemma3-12b (one 5:1 period: five sliding-window layers of window
8 and a global one, qk-norm over each head, tied embeddings, the
``sqrt(d_model)`` embed scale) with bridged weights: the loss and every
gradient leaf against the reference's ``jax.value_and_grad``, two train
steps against its jitted step, remat and the chunked CE against the
plain model, and ``train()`` through ``Cluster.submit`` against the
``JaxExecutor``.  K5's plain backward at head dim 256 -- the width the
CUDA kernels take gemma3's attention at -- is held against the Pallas
backward, interpreted.  Inputs come from numpy seeds; each test states
its tolerance.
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
from repro.models.transformer import ImplConfig as JaxImplConfig
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100, Plan
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref)
from repro_torch.launch.train import train, training_app
from repro_torch.models.model import Model, init_params
from repro_torch.models.transformer import ImplConfig
from repro_torch.runtime import (Application, Cluster, NullExecutor,
                                 TorchExecutor)
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step

ARCH = "gemma3-12b"
# the chip run's cut and plan: two 5:1 periods, one sequence a
# microbatch, the CE in chunks of 1024 positions
CUT_LAYERS = 12
OVERRIDES = {"remat": "full", "microbatch": 8, "loss_chunk": 1024}
TRAIN_4K_B8 = ShapeConfig("train_4k_b8", "train", 4096, 8)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _cfgs():
    return (jax_reduced(jax_get_config(ARCH)),
            reduced_config(get_config(ARCH)))


def _jax_params(jcfg, seed=0):
    """The reference's init plus noise, so the (1+g) norm gains -- the
    q- and k-norms' among them -- are not all zero."""
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


def test_reduced_config_is_one_gemma3_period():
    """The reduced config keeps what gemma3 trains with: 5 windowed layers
    and a global one, qk-norm, tied embeddings and the embed scale, at the
    reference's reduced widths; the port's backward kernels take the full
    config's head dim."""
    jcfg, tcfg = _cfgs()
    assert tcfg.pattern == (ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,)
    assert tcfg.num_layers == jcfg.num_layers == 6
    assert tcfg.sliding_window == jcfg.sliding_window == 8
    assert tcfg.use_qk_norm and tcfg.tie_embeddings and tcfg.scale_embed
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.head_dim) == (jcfg.d_model, jcfg.num_heads,
                               jcfg.num_kv_heads, jcfg.head_dim)
    assert get_config(ARCH).head_dim in BWD_HEAD_DIMS


# ---------------------------------------------------------------------------
# The model: loss and gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_loss_and_grads_match_reference(dtype):
    """Bridged weights, one ``SyntheticLM`` batch (seq 64, batch 8, so the
    window of 8 masks most pairs): the port's ``loss_fn`` + ``backward()``
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` (naive
    attention, no remat), every leaf compared -- each layer's ``q_norm``
    and ``k_norm`` and the tied ``embed``, which takes both the lookup's
    and the output head's gradient, named among them.  bf16 (the models'
    dtype): loss within 1e-3 relative, each leaf within 2e-2 relative
    norm.  fp32 weights: the same function in another summation order;
    loss within 1e-5, each leaf within 1e-4."""
    jcfg, tcfg = _cfgs()
    jparams = _jax_params(jcfg)
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(np.float32), jparams)
    nb, tb = _batch(tcfg)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none", attn_impl="naive"))
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jbatch)[0])(
            jax.tree.map(jnp.asarray, jparams))
    loss, grads = _port_grads(Model(tcfg, ImplConfig(remat="none")),
                              params_from_jax(jparams, tcfg, "cpu"), tb)
    loss_tol, grad_tol = (1e-3, 2e-2) if dtype == "bfloat16" else (1e-5, 1e-4)
    assert abs(float(loss) - float(jloss)) <= loss_tol * abs(float(jloss))
    flat_j = [(jax.tree_util.keystr(path), g) for path, g in
              jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    flat_t = topt.leaves(grads)
    assert len(flat_j) == len(flat_t)
    keys = " ".join(k for k, _ in flat_j)
    for name in ("q_norm", "k_norm", "embed"):
        assert name in keys, name
    assert "head" not in keys                     # tied: no output head
    for (key, gj), gt in zip(flat_j, flat_t):
        assert gt.dtype == getattr(torch, dtype)
        assert float(np.abs(np.asarray(gj, np.float32)).max()) > 0, key
        err = _rel(gt, gj)
        assert err <= grad_tol, (key, err)


def test_train_step_matches_reference():
    """Two steps of 2 microbatches on reduced gemma3 with bridged fp32
    weights and the same batches: the port's eager step against the
    reference's jitted one.  Losses within 1e-3 relative; the params
    within 1e-2 relative norm per leaf, as
    ``tests/test_torch_training.py`` holds tinyllama's."""
    jcfg, tcfg = _cfgs()
    jparams = jax.tree.map(lambda a: a.astype(np.float32),
                           _jax_params(jcfg, seed=1))
    ocfg = dict(warmup_steps=1, peak_lr=1e-3)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none"))
    jplan = JaxPlan("t", "train_4k", SINGLE_POD, microbatch=2, remat="none")
    jstep = jax.jit(jax_make_train_step(jmodel, jplan,
                                        jopt.OptimizerConfig(**ocfg)))
    tstep = make_train_step(Model(tcfg, ImplConfig(remat="none")),
                            Plan("t", "train_4k", H100, microbatch=2),
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


def test_remat_and_loss_chunk_do_not_change_the_gradients():
    """``remat="full"`` and ``"dots"`` recompute the blocks in the
    backward: bit-equal loss and gradients to ``"none"`` on the CPU (the
    same ops on the same inputs in the same order).  ``loss_chunk``
    streams the CE over 16-position chunks, as the chip run's 1024 do over
    the 262144-id vocabulary: the loss within 1e-6 relative (fp32
    summation order of the CE), each gradient leaf within 1e-2 relative
    norm (the bf16 logits' gradient rounded per chunk)."""
    _, tcfg = _cfgs()
    params = init_params(tcfg, 3, "cpu")
    _, batch = _batch(tcfg)
    base_loss, base = _port_grads(Model(tcfg, ImplConfig(remat="none")),
                                  params, batch)
    for remat in ("full", "dots"):
        loss, grads = _port_grads(Model(tcfg, ImplConfig(remat=remat)),
                                  params, batch)
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(topt.leaves(grads), topt.leaves(base)):
            assert torch.equal(a, b), remat
    loss, grads = _port_grads(
        Model(tcfg, ImplConfig(remat="full", loss_chunk=16)), params, batch)
    np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6)
    for a, b in zip(topt.leaves(grads), topt.leaves(base)):
        assert _rel(a, b.float().numpy()) <= 1e-2


# ---------------------------------------------------------------------------
# K5 at head dim 256: the plain backward against the Pallas backward
# ---------------------------------------------------------------------------

def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("s,causal,window", [
    (128, True, 0),       # a global layer: causal
    (192, True, 48),      # a local layer: the window inside a tile
    (128, False, 0),
])
def test_flash_attention_bwd_ref_matches_pallas_at_256(s, causal, window):
    """q (1,4,S,256) over k/v (1,2,S,256), fp32: the plain backward against
    the Pallas backward (interpreted, 64 x 64 blocks) within 1e-4
    absolute -- fp32 summation order over 256-wide products; the CPU
    wrappers are the plain versions, pass by pass."""
    rng = np.random.default_rng(s + window + 256)
    q, do = (rng.standard_normal((1, 4, s, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, s, 256)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    o, lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    want = jax_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                   jnp.asarray(do), **kw)
    args = (_t32(q), _t32(k), _t32(v), _t32(o), _t32(lse), _t32(do))
    got = flash_attention_bwd_ref(*args, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    for g, w in zip(flash_attention_bwd(*args, causal=causal, window=window),
                    got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("h,kvh,s,causal,window", [
    (16, 8, 128, True, 0),      # gemma3's 16/8 heads, a global layer
    (4, 2, 192, True, 48),      # a local layer
])
def test_flash_attention_bwd_ref_bf16_operands_at_256(h, kvh, s, causal,
                                                      window):
    """bf16 inputs at head dim 256.  The plain backward with
    ``operand_dtype=torch.bfloat16`` (p and ds rounded where the bf16
    tensor-core kernels round them) lies within 1e-2 relative norm of the
    fp32 plain version and of the Pallas backward (interpreted, fp32 on
    the same values), and more than 1e-4 from the fp32 plain version, so
    the rounding is applied; ``operand_dtype=None`` is the default call,
    bit for bit."""
    rng = np.random.default_rng(h + s + window)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, do = bf16((1, h, s, 256)), bf16((1, h, s, 256))
    k, v = bf16((1, kvh, s, 256)), bf16((1, kvh, s, 256))
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    qj, kj, vj, doj = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    o_j, lse_j = jax_fwd(qj, kj, vj, **kw)
    o, lse = _t32(o_j).to(torch.bfloat16), _t32(lse_j)
    pallas = jax_bwd(qj, kj, vj, jnp.asarray(o.float().numpy()), lse_j, doj,
                     **kw)
    args = (q, k, v, o, lse, do)
    opts = dict(causal=causal, window=window)
    fp32 = flash_attention_bwd_ref(*args, **opts)
    rounded = flash_attention_bwd_ref(*args, operand_dtype=torch.bfloat16,
                                      **opts)
    for got, want, ref in zip(rounded, fp32, pallas):
        assert got.dtype == torch.bfloat16
        assert 1e-4 < _rel(got, want.float().numpy()) <= 1e-2
        assert _rel(got, np.asarray(ref)) <= 1e-2
    unrounded = flash_attention_bwd_ref(*args, operand_dtype=None, **opts)
    assert all(torch.equal(a, w) for a, w in zip(unrounded, fp32))


# ---------------------------------------------------------------------------
# The entry point and the runtime
# ---------------------------------------------------------------------------

def test_train_gemma3_reduced_lowers_the_loss():
    """``train("gemma3-12b", reduced=True, device="cpu")`` through
    ``Cluster.submit``: 8 steps at lr 1e-2, the mean of the last steps'
    losses below the first ones'; every step's loss finite."""
    out = train(ARCH, reduced=True, device="cpu", steps=8,
                opt_cfg=topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2),
                verbose=False)
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert out["model"].cfg.name == ARCH
    assert "head" not in out["params"]["embed"]


class _BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights."""

    def __init__(self, jax_params, **kw):
        super().__init__(**kw)
        self.jax_params = jax_params

    def init_params(self, handle):
        return params_from_jax(self.jax_params, handle.app.config,
                               self.device)


def test_cluster_training_matches_reference():
    """Reduced gemma3 training through ``Cluster.submit`` on both
    packages: the ladder's plan equals the reference's, and three steps
    from the reference's weights on the same batches give losses within
    1e-3 relative of its jitted steps (as
    ``tests/test_torch_runtime.py`` holds tinyllama's)."""
    ocfg = dict(warmup_steps=1, peak_lr=1e-3)
    jc = JaxCluster(pods=1, executor=JaxExecutor(
        opt_cfg=jopt.OptimizerConfig(**ocfg)))
    jhandle = jc.submit(JaxApp.train(ARCH, reduced=True))
    jparams = jax.tree.map(np.asarray, jhandle.exec_state["params"])
    jhandle.run(steps=3)
    tc = Cluster(pods=1, executor=_BridgedExecutor(
        jparams, device="cpu", opt_cfg=topt.OptimizerConfig(**ocfg)))
    thandle = tc.submit(Application.train(ARCH, reduced=True))
    out = thandle.run(steps=3)
    assert out["steps"] == 3
    for tm, jm in zip(thandle.metrics, jhandle.metrics):
        assert abs(tm["loss"] - jm["loss"]) <= 1e-3 * abs(jm["loss"])
    assert (thandle.plan.remat, thandle.plan.microbatch) == \
        (jhandle.plan.remat, jhandle.plan.microbatch)
    thandle.release()
    jhandle.release()


def test_full_depth_is_refused_and_the_cut_admitted(monkeypatch):
    """gemma3-12b at its full 48 layers, train seq 4096 x batch 8 with the
    chip run's plan fields: the ladder is exhausted at 180.85 GiB, so
    ``train`` raises before any weights are made, naming that demand.
    Cut to two 5:1 periods (12 layers, 10 windowed) the same plan is
    estimated at 59.93 GiB and the cluster admits it (host arithmetic:
    the ``NullExecutor`` places it and binds nothing)."""
    made = []
    monkeypatch.setattr(TorchExecutor, "init_params",
                        lambda self, handle: made.append(handle))
    with pytest.raises(RuntimeError, match="demand 180.85 GiB does not fit"):
        train(ARCH, shape=TRAIN_4K_B8, overrides=OVERRIDES, device="cpu",
              steps=1, verbose=False)
    assert made == []
    cut = get_config(ARCH).scaled(num_layers=CUT_LAYERS)
    assert cut.pattern.count(ATTN_LOCAL) * cut.num_blocks == 10
    app, overrides = training_app(cut, TRAIN_4K_B8, overrides=OVERRIDES)
    assert f"{app.demand_bytes / 2**30:.2f}" == "59.93"
    handle = Cluster(pods=1, mesh=H100, executor=NullExecutor()).submit(
        app, overrides=overrides)
    assert handle.state == "running"
    assert (handle.plan.remat, handle.plan.microbatch,
            handle.plan.loss_chunk) == ("full", 8, 1024)
    assert handle.plan.est_bytes_per_device == app.demand_bytes \
        < H100.hbm_per_device
