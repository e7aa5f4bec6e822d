"""Training of the MoE, vision-language and encoder-decoder families --
qwen2-moe-a2.7b, dbrx-132b, phi-3-vision-4.2b and whisper-base -- in the
port against the JAX package's, on CPU.

The whole model's loss, ``ce``, ``aux`` and every gradient leaf against
the reference's ``jax.value_and_grad`` on bridged weights (the MoE
configs with enough tokens that the experts' capacity drops pairs,
phi-3-vision with and without image embeddings, whisper with its
encoder's frames); train steps of 2 microbatches against the reference's
jitted step; ``remat="full"`` bit-equal to ``"none"``; ``launch.train``
through ``Cluster.submit``; and the plain flash-attention backward at
phi-3's head dim 96 and non-causal at Sq != Sk (whisper's cross
attention) against the Pallas backward, interpreted.  Inputs come from
numpy seeds; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.materializer import SINGLE_POD
from repro.core.materializer import Plan as JaxPlan
from repro.kernels.flash_attention import flash_attention_bwd as jax_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.models import build_model
from repro.models.transformer import ImplConfig as JaxImplConfig
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100, Plan
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_ref)
from repro_torch.launch.train import train
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import MOE_AUX_WEIGHT, Model, init_params
from repro_torch.models.transformer import ImplConfig
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step

SEQ, BATCH = 64, 8          # 512 tokens: the reduced experts overflow
# (arch, whether the batch holds the frontend's inputs)
CASES = [("qwen2-moe-a2.7b", False), ("dbrx-132b", False),
         ("phi-3-vision-4.2b", True), ("phi-3-vision-4.2b", False),
         ("whisper-base", True)]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _cfgs(arch):
    return (jax_reduced(jax_get_config(arch)),
            reduced_config(get_config(arch)))


def _jax_params(jcfg, seed=0):
    """The reference's init plus noise, so the (1+g) norm gains and the
    LayerNorm biases are not all zero."""
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.02).astype(a.dtype),
        jax.tree.map(np.asarray, jparams))


def _batch(cfg, frontend, step=0, seq=SEQ, batch=BATCH, dtype="bfloat16"):
    """A ``SyntheticLM`` batch; with ``frontend`` phi-3's image embeddings
    (B, N, 1024) ahead of seq - N text tokens, or whisper's frames (B, T,
    d), from a numpy seed in the weights' ``dtype``.  -> (numpy dict,
    torch dict)."""
    feats = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    n_img = cfg.num_image_tokens if cfg.family == "vlm" and frontend else 0
    nb = dict(SyntheticLM(DataConfig(cfg.vocab_size, seq - n_img, batch))
              .batch_at(step))
    rng = np.random.default_rng(100 + step)
    if n_img:
        nb["img_feats"] = rng.standard_normal(
            (batch, n_img, 1024)).astype(feats)
    if cfg.is_encdec:
        nb["enc_feats"] = rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(feats)
    return nb, {k: tensor_from_numpy(v, torch.device("cpu"))
                for k, v in nb.items()}


@pytest.fixture(scope="module")
def reference():
    """(arch, frontend, dtype) -> the port's and the reference's reduced
    configs, the bridged weights' host arrays, one batch (numpy and
    torch), the reference's loss, ce and aux, and its gradient leaves (with
    their key paths) on those weights in that dtype, each computed once for
    the module."""
    memo = {}

    def get(arch, frontend, dtype):
        key = (arch, frontend, dtype)
        if key not in memo:
            jcfg, tcfg = _cfgs(arch)
            jparams = _jax_params(jcfg)          # bf16, the models' dtype
            if dtype == "float32":
                jparams = jax.tree.map(lambda a: a.astype(np.float32),
                                       jparams)
            nb, tb = _batch(tcfg, frontend, dtype=dtype)
            jmodel = build_model(jcfg, JaxImplConfig(remat="none",
                                                     attn_impl="naive"))
            jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
            (jloss, jm), jgrads = jax.value_and_grad(
                lambda p: jmodel.loss_fn(p, jbatch), has_aux=True)(
                    jax.tree.map(jnp.asarray, jparams))
            flat = [(jax.tree_util.keystr(path), np.asarray(g, np.float32))
                    for path, g in jax.tree_util.tree_flatten_with_path(
                        jgrads)[0]]
            memo[key] = (tcfg, jcfg, jparams, nb, tb, float(jloss),
                         float(jm["ce"]),
                         float(jm["aux"]), flat)
        return memo[key]

    return get


def _port(model, params, batch):
    """The port's loss, metrics and gradients (``backward()``; a leaf the
    batch does not reach keeps ``grad`` None)."""
    tracked = topt.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    loss, metrics = model.loss_fn(tracked, batch)
    loss.backward()
    return loss.detach(), metrics, topt.tree_map(lambda p: p.grad, tracked)


def _jax_pinned(jcfg, jparams, nb, routes):
    """The reference's gradient leaves, ``jax.value_and_grad`` of its
    ``loss_fn`` on the weights ``jparams``, with each MoE block routed to
    the expert ids in ``routes`` (one (T, k) array per block, in call
    order): while it runs ``jax.lax.top_k`` gathers the router's probabilities at those ids,
    so the reference's own router weights, balance loss, dispatch and
    combine compute the rest.  The blocks are unrolled, since a scan traces
    one block for all of them."""
    pinned, plain = iter(routes), jax.lax.top_k

    def top_k(probs, k):
        ids = jnp.asarray(np.asarray(next(pinned), np.int32))
        assert ids.shape == probs.shape[:-1] + (k,)
        return jnp.take_along_axis(probs, ids, axis=-1), ids

    params = jax.tree.map(jnp.asarray, jparams)
    jmodel = build_model(jcfg, JaxImplConfig(remat="none", attn_impl="naive",
                                             scan_blocks=False))
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jax.lax.top_k = top_k
    try:
        _, grads = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jbatch), has_aux=True)(params)
    finally:
        jax.lax.top_k = plain
    assert next(pinned, None) is None            # one id array per block
    return [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]


class _Drops:
    """Counts the (token, k) pairs the experts' capacity drops while
    active (``dispatch_slots``'s keep mask) and keeps each routing's
    expert ids."""

    def __init__(self, monkeypatch):
        self.pairs, self.routes = 0, []
        plain, route = moe_mod.dispatch_slots, moe_mod.route

        def counting(ids, e_total, cap):
            slot, keep = plain(ids, e_total, cap)
            self.pairs += int((~keep).sum())
            return slot, keep

        def routing(p, x, cfg):
            out = route(p, x, cfg)
            self.routes.append(out[1])
            return out

        monkeypatch.setattr(moe_mod, "dispatch_slots", counting)
        monkeypatch.setattr(moe_mod, "route", routing)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,frontend", CASES)
def test_loss_and_grads_match_reference(reference, monkeypatch, arch,
                                        frontend, dtype):
    """Reduced configs on bridged weights, one batch of 8 x 64 (phi-3: 8
    image embeddings and 56 tokens with ``frontend``, 64 tokens without;
    whisper: 64 tokens over 16 frames): the port's ``loss_fn`` +
    ``backward()`` against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` (naive attention, no remat), the loss, ``ce``, ``aux`` and
    every gradient leaf compared -- the MoE router and experts while the
    capacity drops pairs (counted), phi-3's ``img_proj`` (exactly zero on
    text alone, in both), whisper's encoder and ``cross_*`` weights.

    bf16 (the models' dtype): loss and ce within 1e-3 relative, aux
    within 1e-3 relative, each gradient leaf within 2e-2 relative norm of
    the reference's; where the reference's own bf16 gradient lies further
    than that from its fp32 gradient at the same weights, the port's must
    lie no further from that fp32 gradient than the reference's does.  For
    the MoE configs both bf16 gradients are taken on the same routing, and
    every leaf is held within 2e-2 with no such exception: the reference's
    gradient is recomputed with each block routed to the port's expert ids
    (``_jax_pinned``), since a near-tied token that the two bf16 routers
    send to different experts moves the capacity ranks and the router's
    gradient.  The loss, ce and aux are held to the reference's own
    routing.  fp32
    weights: the same function in fp32 in another summation order; loss,
    ce and aux within 1e-5 relative, each leaf within 1e-4 relative
    norm."""
    tcfg, jcfg, jparams, nb, tb, jloss, jce, jaux, flat_j = reference(
        arch, frontend, dtype)
    drops = _Drops(monkeypatch)
    loss, m, grads = _port(Model(tcfg, ImplConfig(remat="none")),
                           params_from_jax(jparams, tcfg, "cpu"), tb)
    if tcfg.moe is not None:
        assert drops.pairs > 0
        assert jaux > 0
    else:
        assert jaux == 0 and float(m["aux"]) == 0
    tol, grad_tol = (1e-3, 2e-2) if dtype == "bfloat16" else (1e-5, 1e-4)
    assert abs(float(loss) - jloss) <= tol * abs(jloss)
    assert abs(float(m["ce"]) - jce) <= tol * abs(jce)
    assert abs(float(m["aux"]) - jaux) <= tol * abs(jaux)
    assert float(loss) == float(m["ce"] + MOE_AUX_WEIGHT * m["aux"])
    keys = [k for k, _ in flat_j]
    pinned = tcfg.moe is not None and dtype == "bfloat16"
    if pinned:
        flat_j = list(zip(keys, _jax_pinned(jcfg, jparams, nb,
                                            drops.routes)))
    flat_t = topt.leaves(grads)
    assert len(flat_j) == len(flat_t)
    if tcfg.is_encdec:
        assert any("encoder" in k for k in keys)
        assert any("cross_wk" in k for k in keys)
    exact = None
    for (key, gj), gt in zip(flat_j, flat_t):
        if "img_proj" in key and not frontend:
            assert gt is None and not gj.any()      # unreached in both
            continue
        assert gt.dtype == getattr(torch, dtype)
        assert float(np.abs(gj).max()) > 0, key
        err = _rel(gt, gj)
        if err <= grad_tol:
            continue
        assert dtype == "bfloat16" and not pinned, (key, err)
        if exact is None:                  # the fp32 gradient at the weights
            exact = dict(reference(arch, frontend, "float32")[-1])
        ref_err = _rel(torch.from_numpy(gj), exact[key])
        assert ref_err > grad_tol and _rel(gt, exact[key]) <= ref_err, \
            (key, err, ref_err)


@pytest.mark.parametrize("arch,frontend", [("qwen2-moe-a2.7b", False),
                                           ("phi-3-vision-4.2b", True),
                                           ("whisper-base", True)])
def test_train_step_matches_reference(arch, frontend):
    """Two steps of 2 microbatches on bridged fp32 weights and the same
    batches: the port's eager step against the reference's jitted one.
    Microbatch i takes rows i::2 of every key of the batch -- the image
    embeddings and frames with their tokens.  Metrics as the reference's
    at mb > 1: ``ce`` is the loss (aux included), ``aux`` 0.  Loss, ce
    and grad norm within 1e-3 relative, lr within 1e-6; the params within
    1e-2 relative norm per leaf, as
    ``tests/test_torch_training.py::test_train_step_matches_reference``
    holds tinyllama's (fp32 weights, for the reason
    ``tests/test_torch_recurrent_training.py`` gives)."""
    jcfg, tcfg = _cfgs(arch)
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
    for step in range(2):
        # the frontend's inputs in the weights' dtype: fp32 at the first
        # step, bf16 after it (AdamW hands back bf16 weights, as the
        # reference's does)
        nb, tb = _batch(tcfg, frontend, step,
                        dtype="float32" if step == 0 else "bfloat16")
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tp, tst, tm = tstep(tp, tst, tb)
        assert float(tm["aux"]) == float(jm["aux"]) == 0
        assert float(tm["ce"]) == float(tm["loss"])
        for k, tol in (("loss", 1e-3), ("ce", 1e-3), ("grad_norm", 1e-3),
                       ("lr", 1e-6)):
            assert abs(float(tm[k]) - float(jm[k])) <= tol * abs(
                float(jm[k])), k
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            topt.leaves(tp)):
        err = _rel(a, np.asarray(b, np.float32))
        assert err <= 1e-2, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_combine_scatter_is_bit_equal_to_the_gather(arch):
    """The routed experts hand each (token, k) pair its expert's output
    row by scattering every slot's row to the pair that filled it; the
    reference gathers ``out[slot]`` (a dropped pair reads a zero trash
    row).  bf16, 512 tokens, so the capacity drops pairs: the output,
    aux and every gradient bit-equal to the gather's."""
    _, tcfg = _cfgs(arch)
    blocks = init_params(tcfg, 1, "cpu")["blocks"]
    p = {k: v[0] for k, v in blocks[f"p0_{tcfg.pattern[0]}"]["moe"].items()
         if not isinstance(v, dict)}
    e_total = moe_mod.padded_num_experts(tcfg.moe.num_experts)
    gen = torch.Generator().manual_seed(0)
    x0, dy = (torch.randn(512, tcfg.d_model, generator=gen).to(
        torch.bfloat16) for _ in range(2))

    def gather(x, p):
        m, (t, d) = tcfg.moe, x.shape
        cap = moe_mod._capacity(t, e_total, m.top_k, m.capacity_factor)
        weights, ids, aux = moe_mod.route(p["router"], x, tcfg)
        slot, keep = moe_mod.dispatch_slots(ids, e_total, cap)
        assert not bool(keep.all())
        buf = torch.zeros((e_total * cap + 1, d), dtype=x.dtype)
        buf[slot] = x.unsqueeze(1).expand(t, m.top_k, d).reshape(-1, d)
        ebuf = buf[:e_total * cap].view(e_total, cap, d)
        h = torch.nn.functional.silu(torch.bmm(ebuf, p["we_gate"])) \
            * torch.bmm(ebuf, p["we_up"])
        out = torch.bmm(h, p["we_down"]).reshape(e_total * cap, d)
        out = torch.cat([out, out.new_zeros(1, d)])
        return moe_mod.combine(out[slot] * weights.reshape(-1, 1),
                               m.top_k), aux

    results = []
    for fn in (gather, lambda x, q: moe_mod._local_expert_ffn(x, q, tcfg,
                                                              e_total)):
        x = x0.clone().requires_grad_(True)
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, aux = fn(x, q)
        ((y * dy).float().sum() + aux).backward()
        results.append([y, aux, x.grad] + [q[k].grad for k in (
            "router", "we_gate", "we_up", "we_down")])
    assert all(torch.equal(a, b) for a, b in zip(*results))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-base"])
def test_remat_full_gives_the_same_loss_and_gradients(arch):
    """``remat="full"`` against ``"none"`` on the CPU: bit-equal loss,
    ``aux`` and gradients -- the MoE balance loss comes out of the remat
    boundary, and whisper's encoder output goes into it, so the
    recompute's gradient reaches the encoder (its leaves nonzero)."""
    _, tcfg = _cfgs(arch)
    params = init_params(tcfg, 3, "cpu")
    _, batch = _batch(tcfg, True, batch=4)
    out = {}
    for remat in ("none", "full"):
        tracked = topt.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
        loss, m = Model(tcfg, ImplConfig(remat=remat)).loss_fn(tracked,
                                                               batch)
        out[remat] = (loss.detach(), m["aux"].detach(), torch.autograd.grad(
            loss, topt.leaves(tracked)))
    (loss, aux, grads), (loss_f, aux_f, grads_f) = out["none"], out["full"]
    assert torch.equal(loss, loss_f) and torch.equal(aux, aux_f)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_f))
    if tcfg.is_encdec:
        enc = topt.leaves(topt.tree_unflatten(params, grads_f)["encoder"])
        assert enc and all(bool(g.any()) for g in enc)


def test_train_moe_reduced_lowers_the_loss():
    """``train("qwen2-moe-a2.7b", reduced=True, device="cpu")`` through
    ``Cluster.submit``: 8 steps at lr 1e-2 in one microbatch, so the
    metrics carry the balance loss: loss = ce + 0.01 aux (fp32, to 1e-6
    relative), aux > 0, and the mean of the last steps' losses below the
    first ones'."""
    out = train("qwen2-moe-a2.7b", reduced=True, device="cpu", steps=8,
                opt_cfg=topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2),
                verbose=False)
    ms = out["metrics"]
    assert out["plan"].microbatch == 1
    losses = [m["loss"] for m in ms]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    for m in ms:
        assert m["aux"] > 0
        assert abs(m["loss"] - (m["ce"] + MOE_AUX_WEIGHT * m["aux"])) \
            <= 1e-6 * m["loss"]


# ---------------------------------------------------------------------------
# K5: the plain backward at head dim 96 and at Sq != Sk against the Pallas
# backward (interpreted), fp32, within 1e-4 abs (fp32 summation order)
# ---------------------------------------------------------------------------

def _pallas_bwd(q, k, v, do, causal, window):
    """The Pallas forward and backward (interpreted) on numpy fp32 inputs
    -> (o, lse, dq, dk, dv).  The kernels take Sq == Sk; non-causal
    attention at Sq != Sk is row by row, so the queries (and dO) are
    padded with zero rows to a multiple of Sk and run Sk rows at a time:
    a zero query row with zero dO adds nothing to dK or dV, and dK and dV
    are sums over the query rows."""
    sq, sk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if sq == sk:
        o, lse = jax_fwd(jnp.asarray(q), kj, vj, **kw)
        dq, dk, dv = jax_bwd(jnp.asarray(q), kj, vj, o, lse,
                             jnp.asarray(do), **kw)
        return tuple(np.asarray(t) for t in (o, lse, dq, dk, dv))
    assert not causal
    n = -(-sq // sk)
    pad = np.zeros(q.shape[:2] + (n * sk - sq, q.shape[3]), np.float32)
    qp, dop = (np.concatenate([t, pad], axis=2) for t in (q, do))
    parts = []
    for i in range(n):
        rows = slice(i * sk, (i + 1) * sk)
        qi, doi = jnp.asarray(qp[:, :, rows]), jnp.asarray(dop[:, :, rows])
        o, lse = jax_fwd(qi, kj, vj, **kw)
        parts.append((o, lse) + tuple(jax_bwd(qi, kj, vj, o, lse, doi,
                                              **kw)))
    cat = [np.concatenate([np.asarray(p[j]) for p in parts], axis=2)[:, :, :sq]
           for j in range(3)]
    return (cat[0], cat[1], cat[2], sum(np.asarray(p[3]) for p in parts),
            sum(np.asarray(p[4]) for p in parts))


@pytest.mark.parametrize("b,kvh,sq,sk,d,causal,window", [
    # phi-3-vision-4.2b's head dim (its attention trains through K5)
    (1, 4, 128, 128, 96, True, 0), (2, 2, 64, 64, 96, True, 16),
    (1, 1, 128, 128, 96, False, 0),
    # whisper's cross attention: more decoder rows than frames, and fewer
    (2, 4, 320, 128, 64, False, 0), (1, 2, 80, 192, 32, False, 0),
    (1, 4, 192, 64, 96, False, 0),
])
def test_flash_attention_bwd_ref_matches_pallas_at_96_and_sq_ne_sk(
        b, kvh, sq, sk, d, causal, window):
    h = 4
    rng = np.random.default_rng(b * 1000 + kvh * 100 + sq + sk + d)
    q, do = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
            for _ in range(2))
    o, lse, *want = _pallas_bwd(q, k, v, do, causal, window)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (t(q), t(k), t(v), t(o), t(lse), t(do))
    got = flash_attention_bwd_ref(*args, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    # the CPU wrappers are the plain versions, pass by pass
    for g, w in zip(flash_attention_bwd(*args, causal=causal, window=window),
                    got):
        assert torch.equal(g, w)
