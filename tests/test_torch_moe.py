"""The port's MoE family (``models/moe.py`` and the MoE block) against the
JAX package's, on CPU.

Each test makes its inputs from a seed with numpy and runs the
reference and the port on the same (bridged) weights: the router's
choices and weights, the combine bit for bit against the reference's
bf16 ``segment_sum``, ``moe_block`` with and without capacity drops on
reduced qwen2-moe-a2.7b (shared experts) and dbrx-132b (none),
``Model.prefill`` / ``decode_step`` logits, and greedy tokens served
through both packages' ``Cluster``s on the dense backend.

Tolerances: bf16 rtol/atol 2e-2, fp32 2e-5 (``test_torch_dense.py``);
tokens equal except where the port's top-2 logit gap is below
``TIE_GAP`` (the two frameworks round bf16 at other places).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.history import HistoryStore as JaxHistory
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models.transformer import ImplConfig as JaxImpl
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import ServeOptions as JaxOpts
from repro.serving.kv_cache import Request as JaxRequest
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.history import HistoryStore
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.transformer import ImplConfig
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
from repro_torch.serving.kv_cache import Request

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TIE_GAP = 1e-2
ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]


def pair(a, dtype="bfloat16"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a).astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                             else np.float32)
    return jnp.asarray(a), tensor_from_numpy(a, torch.device("cpu"))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def bits(t):
    return t.view(torch.int16).numpy()


def cfgs(arch):
    return (jax_reduced(jax_get_config(arch)),
            reduced_config(get_config(arch)))


def _bridged(arch, seed=0):
    """Reduced configs; the reference's params with every leaf perturbed
    (nonzero norm gains too), as numpy and bridged into the port."""
    jcfg, tcfg = cfgs(arch)
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    host = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, host, params_from_jax(host, tcfg, "cpu")


def _moe_params(host, tparams, tcfg):
    key = f"p0_{tcfg.pattern[0]}"
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), host["blocks"][key]["moe"])
    tp = jax.tree.map(lambda t: t[0], tparams["blocks"][key]["moe"])
    return jp, tp


# ---------------------------------------------------------------------------
# the router, the dispatch and the combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """Expert ids equal wherever the k-th and (k+1)-th probabilities are
    more than 1e-3 apart; the rows where they are not number exactly 3 of
    96 on these inputs (one an exact bf16 tie), and there the two choices
    are equally good, their probabilities summing to within 1e-3 of each
    other.  The weights at the bf16 tolerance and the balance loss at
    fp32's."""
    jcfg, tcfg, host, tparams = _bridged(arch)
    jp, tp = _moe_params(host, tparams, tcfg)
    rng = np.random.default_rng(1)
    xj, xt = pair(rng.standard_normal((96, tcfg.d_model)))
    jw, jids, jaux = jmoe.route(jp["router"], xj, jcfg)
    tw, tids, taux = moe.route(tp["router"], xt, tcfg)
    logits = torch.matmul(xt, tp["router"]).float()
    logits[:, tcfg.moe.num_experts:] = moe.NEG
    probs = torch.softmax(logits, -1)
    top = probs.sort(-1, descending=True).values
    k = tcfg.moe.top_k
    clear = (top[:, k - 1] - top[:, k]) > 1e-3
    jids = torch.from_numpy(np.asarray(jids, np.int64))
    assert int((~clear).sum()) == 3
    assert torch.equal(tids[clear], jids[clear])
    mass = (probs.gather(1, tids) - probs.gather(1, jids)).sum(1)
    assert all(abs(float(m)) <= 1e-3 for m in mass[~clear])
    assert int(tids.max()) < tcfg.moe.num_experts      # pads never chosen
    same = (tids == jids).all(1)
    close(tw[same], np.asarray(jw, np.float32)[same.numpy()],
          TOL["bfloat16"])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])


def test_route_orders_tied_experts_as_lax_top_k():
    """Equal probabilities keep the lower expert first, as ``lax.top_k``
    does: the order decides dispatch ranks and the combine's adds."""
    _, tcfg = cfgs("dbrx-132b")
    d = tcfg.d_model
    router = np.zeros((d, 16), np.float32)
    router[0, [1, 5, 6]] = [2.0, 3.0, 3.0]       # experts 5 and 6 tie
    x = np.zeros((3, d), np.float32)
    x[:, 0] = 1.0
    jr, tr = pair(router)
    xj, xt = pair(x)
    _, jids, _ = jmoe.route(jr, xj, jax_reduced(jax_get_config("dbrx-132b")))
    _, tids, _ = moe.route(tr, xt, tcfg)
    assert tids.tolist() == np.asarray(jids).tolist() == [[5, 6]] * 3


@pytest.mark.parametrize("t,k,d", [(512, 4, 256), (37, 2, 64), (8, 4, 2048)])
def test_combine_is_bit_equal_to_segment_sum(t, k, d):
    """The k slot outputs added one bf16 add at a time in slot order equal
    the reference's bf16 ``segment_sum`` bit for bit; the fp32-accumulating
    sum over the slots does not (it rounds once)."""
    rng = np.random.default_rng(t + k)
    gj, gt = pair(rng.standard_normal((t * k, d)))
    token_of = jnp.repeat(jnp.arange(t), k)
    want = jax.ops.segment_sum(gj, token_of, num_segments=t)
    got = moe.combine(gt, k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bits(got), np.asarray(want).view(np.int16))
    if t * d >= 4096 and k > 2:
        once = gt.unflatten(0, (t, k)).float().sum(1).to(torch.bfloat16)
        assert not np.array_equal(bits(once), bits(got))


def test_dispatch_slots_ranks_and_drops():
    """A stable rank per expert in token-major order; pairs past the
    capacity go to the trash row."""
    ids = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 3]])
    slot, keep = moe.dispatch_slots(ids, 4, 2)
    # expert 0 sees pairs 0, 2, 5, 6 (ranks 0, 1, 2, 3): the last two drop
    assert slot.tolist() == [0, 2, 1, 4, 3, 8, 8, 6]
    assert keep.tolist() == [True, True, True, True, True, False, False,
                             True]


# ---------------------------------------------------------------------------
# moe_block against the reference's single-shard path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,drops", [(2, 48, True), (1, 4, False)])
def test_moe_block_matches_reference(arch, b, s, drops):
    """``moe_block(shard_ctx=None)`` on bridged weights, bf16, at a token
    count where experts overflow their capacity and drop tokens and at
    one where none does (the drops are counted, so the case is what it
    says); the aux loss at fp32's tolerance."""
    jcfg, tcfg, host, tparams = _bridged(arch)
    jp, tp = _moe_params(host, tparams, tcfg)
    rng = np.random.default_rng(b * s)
    xj, xt = pair(rng.standard_normal((b, s, tcfg.d_model)))
    m = tcfg.moe
    e_pad = moe.padded_num_experts(m.num_experts)
    _, ids, _ = moe.route(tp["router"], xt.reshape(b * s, -1), tcfg)
    cap = moe._capacity(b * s, e_pad, m.top_k, m.capacity_factor)
    _, keep = moe.dispatch_slots(ids, e_pad, cap)
    assert bool((~keep).any()) == drops
    want_y, want_aux = jmoe.moe_block(jp, xj, jcfg, shard_ctx=None)
    got_y, got_aux = moe.moe_block(tp, xt, tcfg)
    assert got_y.dtype == torch.bfloat16 and got_y.shape == (b, s, tcfg.d_model)
    close(got_y, want_y, TOL["bfloat16"])
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               **TOL["float32"])


def test_moe_block_with_a_shard_ctx_names_the_multi_card_item():
    """A ``shard_ctx`` runs the expert-parallel dispatch over a mesh
    (``tests/test_torch_expert_parallel.py``, the multi-card item A8b);
    one it cannot run is refused before any collective: experts split
    over an axis the batch splits too, or another axis than 'model'."""
    _, tcfg, _, tparams = _bridged("qwen2-moe-a2.7b")
    tp = jax.tree.map(lambda t: t[0], tparams["blocks"]["p0_moe"]["moe"])
    x = torch.zeros(1, 2, tcfg.d_model, dtype=torch.bfloat16)
    for ctx in (("mesh", "model", ("data", "model")),
                ("mesh", "data", ("model",))):
        with pytest.raises(ValueError, match="'model' axis"):
            moe.moe_block(tp, x, tcfg, shard_ctx=ctx)


def test_init_draws_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """A leaf larger than ``INIT_SLICE_ELEMS`` (a full-width expert stack)
    is drawn in runs of its leading dim of at most that many elements,
    each run as a leaf of its shape is drawn, so no fp32 copy of the whole
    leaf is made; a smaller leaf is drawn in one piece, bit-equal to the
    one-piece draw."""
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "INIT_SLICE_ELEMS", 350)
    specs = {"big": L.Spec((3, 10, 16)), "small": L.Spec((6, 10), std=0.5)}
    randn, drawn = torch.randn, []

    def counting(shape, **kw):
        drawn.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", counting)
    got = L.init_from_specs(specs, torch.Generator().manual_seed(5),
                            torch.device("cpu"))
    monkeypatch.setattr(torch, "randn", randn)
    assert drawn == [(2, 10, 16), (10, 16), (6, 10)]
    gen = torch.Generator().manual_seed(5)

    def piece(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * std).to(torch.bfloat16)

    big = torch.cat([piece((2, 10, 16), 0.02), piece((1, 10, 16), 0.02)])
    assert np.array_equal(bits(got["big"]), bits(big))
    assert np.array_equal(bits(got["small"]), bits(piece((6, 10), 0.5)))


# ---------------------------------------------------------------------------
# the model's serving entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """``Model.prefill`` over 2 prompts of 24 tokens and a decode step at
    position 24, on bridged weights: logits within the bf16 tolerance."""
    jcfg, tcfg, host, tparams = _bridged(arch)
    jmodel = build_model(jcfg, JaxImpl(remat="none"))
    jparams = jax.tree.map(jnp.asarray, host)
    model = Model(tcfg, ImplConfig(remat="none"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 25))
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :24], jnp.int32)}, 32)
    got, cache = model.prefill(tparams, torch.from_numpy(toks[:, :24]), 32)
    close(got, want, TOL["bfloat16"])
    want, _ = jmodel.decode_step(jparams, jnp.asarray(toks[:, 24:], jnp.int32),
                                 jcache, jnp.asarray(24, jnp.int32))
    got, _ = model.decode_step(tparams, torch.from_numpy(toks[:, 24:]), cache,
                               24)
    close(got, want, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the slice: both packages' Clusters on the dense backend
# ---------------------------------------------------------------------------

class BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights."""

    def __init__(self, jax_params, **kw):
        super().__init__(**kw)
        self.jax_params = jax_params

    def init_params(self, handle):
        return params_from_jax(self.jax_params, handle.app.config,
                               self.device)


def _opts(**kw):
    return dict(max_batch=4, pool_pages=32, cache_len=256, policy="fixed",
                backend="dense", **kw)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, n)) for n in lens]


def serve_both(arch, prompts, max_new):
    """The reference's Cluster (seed 0) and the port's on its weights ->
    (reference tokens, port tokens, port margins, port stats)."""
    cluster = JaxCluster(pods=1, history=JaxHistory(),
                         executor=JaxExecutor(seed=0))
    h = cluster.submit(JaxApp.serve(arch, reduced=True,
                                    serve=JaxOpts(**_opts())))
    reqs = [JaxRequest(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        h.submit_request(r)
    h.run(max_steps=5000)
    want = {r.req_id: r.output_tokens for r in reqs}
    params = jax.tree.map(np.asarray, h.runner.params)
    h.release()

    cluster = Cluster(history=HistoryStore(),
                      executor=BridgedExecutor(params, device="cpu"))
    h = cluster.submit(Application.serve(
        arch, reduced=True, serve=ServeOptions(private_pool=True,
                                               **_opts())))
    h.runner.margins = {}
    reqs = [Request(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        h.submit_request(r)
    stats = h.run(max_steps=5000)
    margins = h.runner.margins
    h.release()
    return want, {r.req_id: r.output_tokens for r in reqs}, margins, stats


def near_tie_equal(want, got, margins):
    """Equal tokens, except that a request may diverge at a step where
    the port's top-2 gap is below ``TIE_GAP`` (then it stops being
    compared).  Returns the number of such divergences."""
    flips = 0
    for rid, w in want.items():
        assert len(got[rid]) == len(w), rid
        for j, (a, b) in enumerate(zip(w, got[rid])):
            if a != b:
                gap = margins[rid][j]
                assert gap < TIE_GAP, (
                    f"{rid} token {j}: port {b} vs reference {a} at a "
                    f"top-2 logit gap of {gap:.3e} (>= {TIE_GAP})")
                flips += 1
                break
    return flips


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_dense_serve_matches_reference_cluster(arch):
    """4 requests of 9..130 tokens, 6 new each, through ``Cluster.submit``
    on the dense backend of both packages: decode routes all 4 lanes at
    the shared position, prefill drops tokens at the longer prompts."""
    prompts = _prompts(256, (9, 130, 77, 40))
    want, got, margins, stats = serve_both(arch, prompts, 6)
    assert stats["completed"] == 4
    assert near_tie_equal(want, got, margins) <= 1
