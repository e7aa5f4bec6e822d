"""Sliding-window ring pages, the dense ring cache, head dim 256 and the
three configs copied with them, on CPU, against the JAX package.

The serving cases are the reference's own (``tests/test_serving.py``:
ring accounting, paged-vs-dense tokens on reduced gemma3-12b past a ring
wrap, ``swa_rings=False``, the ring page cap over a long generation, no
dense prefill on the paged runner), each run through the port's
``Cluster`` with the reference's weights (bridged) and explicit prompts,
and held against the reference's ``Cluster``: the port's two backends
give EQUAL tokens, and they equal the reference's except where the
port's top-2 logit gap is below ``TIE_GAP`` (``PERF.md`` §2; the two
frameworks round bf16 at other places).  The dense ring decode is held
against the full forward (``tests/test_models_property.py``) below and
above the window.  The plain versions of K1, K2 and K4 at head dim 256
are held against the reference's oracle and Pallas kernels (interpreted);
each test states its tolerance.  Last, reduced mistral-nemo-12b and
command-r-35b tokens against the reference's, and the full-width
parameter counts of the three configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.history import HistoryStore as JaxHistory
from repro.core.profiles import model_param_count as jax_param_count
from repro.kernels import ops, ref
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import ServeOptions as JaxOpts
from repro.serving.kv_cache import PageGroups as JaxGroups
from repro.serving.kv_cache import PagePool as JaxPool
from repro.serving.kv_cache import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.history import HistoryStore
from repro_torch.core.profiles import model_param_count
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_split_ref)
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_fwd_ref,
                                                 fwd_block_k)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_split_ref)
from repro_torch.models.model import Model, init_params
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
from repro_torch.serving.kv_cache import (PAGE_SIZE, PageGroups, PagePool,
                                         Request)

TIE_GAP = 1e-2
FP32 = dict(atol=2e-5, rtol=2e-5)      # fp32: summation order only


# ---------------------------------------------------------------------------
# serving through both packages' Clusters
# ---------------------------------------------------------------------------

class BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights."""

    def __init__(self, jax_params, **kw):
        super().__init__(**kw)
        self.jax_params = jax_params

    def init_params(self, handle):
        return params_from_jax(self.jax_params, handle.app.config,
                               self.device)


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, 256, length))
            for _ in range(n)]


def _opts(backend, **kw):
    return dict(max_batch=4, pool_pages=32, cache_len=512, policy="fixed",
                backend=backend, **kw)


def _serve_jax(arch, backend, prompts, max_new, **kw):
    """The reference's Cluster (seed 0) -> (tokens, numpy params)."""
    cluster = JaxCluster(pods=1, history=JaxHistory(),
                         executor=JaxExecutor(seed=0))
    h = cluster.submit(JaxApp.serve(arch, reduced=True,
                                    serve=JaxOpts(**_opts(backend, **kw))))
    reqs = [JaxRequest(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        h.submit_request(r)
    h.run(max_steps=5000)
    params = jax.tree.map(np.asarray, h.runner.params)
    h.release()
    return {r.req_id: r.output_tokens for r in reqs}, params


def _serve(arch, backend, prompts, max_new, params, **kw):
    """The port's Cluster on the reference's weights -> (stats, tokens,
    margins)."""
    cluster = Cluster(history=HistoryStore(),
                      executor=BridgedExecutor(params, device="cpu"))
    h = cluster.submit(Application.serve(
        arch, reduced=True,
        serve=ServeOptions(private_pool=True, **_opts(backend, **kw))))
    h.runner.margins = {}
    reqs = [Request(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        h.submit_request(r)
    stats = h.run(max_steps=5000)
    margins = h.runner.margins
    h.release()
    return stats, {r.req_id: r.output_tokens for r in reqs}, margins


def _near_tie_equal(want, got, margins):
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


@pytest.fixture(scope="module")
def gemma3_reference():
    """Reduced gemma3-12b (5 local : 1 global, window 8, rings of 2
    pages): two prompts of 200 tokens and 70 new, so the generation runs
    past ``ring_pages * PAGE_SIZE`` = 256 and the rings wrap.  The
    reference's paged tokens (rings on) and its weights."""
    prompts = _prompts(2, 200)
    toks, params = _serve_jax("gemma3-12b", "paged", prompts, 70)
    return prompts, toks, params


def test_page_groups_ring_accounting():
    """The reference's unit case, both pools driven alike: the ring stops
    charging past ``ceil(window/PAGE_SIZE)+1`` pages while the global
    table keeps growing, the grants are the same page ids, and release
    returns both id spaces intact."""
    cfg = reduced_config(get_config("gemma3-12b"))
    groups = PageGroups.from_config(cfg)
    jgroups = JaxGroups.from_config(jax_reduced(jax_get_config("gemma3-12b")))
    assert (groups.local_layers, groups.global_layers, groups.ring_pages) \
        == (jgroups.local_layers, jgroups.global_layers,
            jgroups.ring_pages) == (5, 1, 2)
    assert (groups.w_global, groups.w_local) == (jgroups.w_global,
                                                 jgroups.w_local)
    pools = [PagePool(32, policy="fixed", fixed_init_pages=1,
                      fixed_step_pages=1, groups=groups),
             JaxPool(32, policy="fixed", fixed_init_pages=1,
                     fixed_step_pages=1, groups=jgroups)]
    reqs = [Request("r", prompt_len=PAGE_SIZE, max_new_tokens=PAGE_SIZE * 8),
            JaxRequest("r", prompt_len=PAGE_SIZE,
                       max_new_tokens=PAGE_SIZE * 8)]
    for pool, r in zip(pools, reqs):
        assert pool.try_admit(r)
        assert len(r.pages) == 1 and len(r.local_pages) == 1
    for _ in range(8):                         # grow one page at a time
        for pool, r in zip(pools, reqs):
            r.generated += PAGE_SIZE
            assert pool.grow(r, horizon=1)
            assert len(r.local_pages) <= groups.ring_pages
        assert reqs[0].pages == reqs[1].pages
        assert reqs[0].local_pages == reqs[1].local_pages
        assert pools[0].utilization == pools[1].utilization
    r, pool = reqs[0], pools[0]
    assert len(r.pages) == r.pages_needed(1) > groups.ring_pages
    assert len(r.local_pages) == groups.ring_pages == pool.used_local
    assert pool.utilization < len(r.pages) / pool.num_pages
    # drain and restore (replica removal): both id spaces come back and
    # are granted again at the same counts, as the reference's pool does
    held = [p.reclaim(q) for p, q in zip(pools, reqs)]
    assert held[0] == held[1] and pools[0].used_local == 0
    for p, q, (g, l) in zip(pools, reqs, held):
        assert p.regrant(q, len(g), len(l))
    assert reqs[0].pages == reqs[1].pages
    assert reqs[0].local_pages == reqs[1].local_pages
    for pool, r in zip(pools, reqs):
        pool.release(r)
        assert sorted(pool.free) == list(range(32))
        assert sorted(pool.free_local) == list(range(32))
    assert pools[0].used_local == 0 and pools[0].stats == {
        k: pools[1].stats[k] for k in pools[0].stats}


def test_paged_swa_matches_dense_tokens(gemma3_reference):
    """Reduced gemma3: the port's paged backend (ring pages) gives the
    SAME tokens as its dense backend (ring cache), past the ring wrap,
    and the reference's tokens under the near-tie rule."""
    prompts, want, params = gemma3_reference
    dstats, dense, _ = _serve("gemma3-12b", "dense", prompts, 70, params)
    pstats, paged, margins = _serve("gemma3-12b", "paged", prompts, 70,
                                    params)
    assert dstats["completed"] == pstats["completed"] == 2
    assert paged == dense
    assert all(len(t) == 71 for t in paged.values())
    assert _near_tie_equal(want, paged, margins) <= 1


def test_paged_swa_ring_and_no_ring_tokens_identical(gemma3_reference):
    """``swa_rings=False`` keeps decode windowed (local layers read the
    growing table through the window mask) and token-identical; only the
    page charge differs."""
    prompts, _, params = gemma3_reference
    _, ring, _ = _serve("gemma3-12b", "paged", prompts, 70, params)
    _, flat, _ = _serve("gemma3-12b", "paged", prompts, 70, params,
                        swa_rings=False)
    assert ring == flat


def test_swa_ring_page_cap_long_generation():
    """A long generation on a sliding-window stack, through the port's
    ``Cluster``: at most ``ring_pages`` pages on local layers while the
    global table grows past them, and every page back in the pool at the
    end."""
    cluster = Cluster(history=HistoryStore(),
                      executor=TorchExecutor(device="cpu", seed=0))
    h = cluster.submit(Application.serve(
        "gemma3-12b", reduced=True,
        serve=ServeOptions(max_batch=2, pool_pages=32, backend="paged",
                           policy="fixed", private_pool=True)))
    ring = h.runner.groups.ring_pages
    pool = h.engine.pool
    assert pool.groups is not None and pool.groups.ring_pages == ring
    req = Request("long", prompt_len=64, max_new_tokens=PAGE_SIZE * 3)
    h.submit_request(req)
    peak_local = peak_global = 0
    while h.step()["alive"]:
        peak_local = max(peak_local, len(req.local_pages))
        peak_global = max(peak_global, len(req.pages))
    assert peak_local == ring
    assert peak_global > ring, "scenario must outgrow the ring"
    stats = h.stats_view.cumulative()
    assert stats["completed"] == 1 and stats["pool_used_local_pages"] == 0
    assert len(pool.free) == pool.num_pages and pool.used_local == 0
    h.release()


def test_paged_prefill_has_no_dense_detour(monkeypatch):
    """The paged runner prefills a ring stack natively, in one forward
    over its pages, and never through the model's dense ``prefill``."""
    def boom(*a, **k):
        raise AssertionError("dense Model.prefill called by PagedRunner")

    monkeypatch.setattr(Model, "prefill", boom)
    cluster = Cluster(history=HistoryStore(),
                      executor=TorchExecutor(device="cpu", seed=0))
    h = cluster.submit(Application.serve(
        "gemma3-12b", reduced=True,
        serve=ServeOptions(max_batch=2, pool_pages=32, backend="paged",
                           private_pool=True, chunk_pages=1)))
    h.submit_request(Request("r0", 700, 8))
    stats = h.run(max_steps=500)
    assert stats["completed"] == 1
    assert h.runner.prefill_chunks == 1         # 6 pages, never chunked
    h.release()


# ---------------------------------------------------------------------------
# the dense ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt", [5, 20])
def test_decode_ring_buffer_equals_full_forward(prompt):
    """One local-attention layer, window 8, cache 64 (a ring of 8 slots):
    prefill over ``prompt`` tokens then decode the next one equals a
    prefill over all ``prompt + 1`` tokens -- below the window (no wrap)
    and above it (the prefill keeps the rolled tail).  bf16 weights and
    cache, as the reference's test: logits within rtol 0.1 / atol 0.25
    and the same argmax."""
    cfg = reduced_config(get_config("gemma3-12b")).scaled(
        pattern=(ATTN_LOCAL,), num_layers=1, sliding_window=8)
    params = init_params(cfg, seed=0, device="cpu")
    model = Model(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, prompt + 1)))
    cache = model.init_cache(2, 64, "cpu")
    assert cache["p0_attn_local"]["k"].shape[3] == 8     # (nb, B, KV, S, hd)
    model.prefill(params, toks[:, :prompt], 64, cache=cache)
    la, _ = model.decode_step(params, toks[:, prompt:], cache, prompt)
    lb, _ = model.prefill(params, toks, 64)
    np.testing.assert_allclose(la[:, -1].float().numpy(),
                               lb[:, -1].float().numpy(), rtol=0.1,
                               atol=0.25)
    assert torch.equal(la[:, -1].argmax(-1), lb[:, -1].argmax(-1))


# ---------------------------------------------------------------------------
# K1, K2, K4 at head dim 256: the plain versions against the reference
# ---------------------------------------------------------------------------

def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window,ring", [(0, False), (200, False),
                                         (200, True)])
def test_paged_attention_d256_matches_reference(window, ring):
    """gemma3's decode head shape (G = 2, D = 256) on pages of 128: linear
    tables, a window over them, and a 3-page ring read with the window
    after it has wrapped (valid lengths past 384).  The plain version and
    the kernel's split form against the Pallas kernel (interpreted) and
    the oracle, fp32, within 2e-5 (summation order)."""
    rng = np.random.default_rng(window + ring)
    b, h, kvh, d, pool, maxp = 3, 4, 2, 256, 12, 3
    q, kp, vp = (_f32(rng, b, h, d), _f32(rng, pool, PAGE_SIZE, kvh, d),
                 _f32(rng, pool, PAGE_SIZE, kvh, d))
    table = np.stack([rng.choice(pool, maxp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    vlen = np.asarray([900, 300, 385] if ring else [384, 300, 1], np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, vlen)]
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, vlen)]
    want = np.asarray(jax_paged(*jargs, window=window, ring=ring))
    np.testing.assert_allclose(
        want, np.asarray(jax_paged_ref(*jargs, window=window, ring=ring)),
        **FP32)
    got = paged_attention(*targs, window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    assert torch.equal(got, paged_attention_ref(*targs, window=window,
                                                ring=ring))
    for pps in (1, 2):
        np.testing.assert_allclose(
            paged_attention_split_ref(*targs, window=window, ring=ring,
                                      pages_per_split=pps).numpy(),
            want, **FP32)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_fwd_d256_matches_pallas(window):
    """gemma3's prefill head shape (G = 2, D = 256), causal, with a window
    and without.  fp32: the plain version and the kernel's tile form over
    ``fwd_block_k(256)`` = 32 keys against the Pallas forward
    (interpreted), o and lse within 2e-5.  bf16 operands (the tensor-core
    kernel's rounding of p): within 1e-2 relative norm of the Pallas
    forward on the same values, lse within 1e-5."""
    assert fwd_block_k(256) == 32 and fwd_block_k(128) == 64
    rng = np.random.default_rng(256 + window)
    b, h, kvh, s, d = 1, 4, 2, 192, 256
    q, k, v = _f32(rng, b, h, s, d), _f32(rng, b, kvh, s, d), \
        _f32(rng, b, kvh, s, d)
    o_j, lse_j = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, block_q=64, block_k=64)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for o, lse in (flash_attention_fwd(tq, tk, tv, causal=True,
                                       window=window),
                   flash_attention_fwd_ref(tq, tk, tv, causal=True,
                                           window=window,
                                           operand_dtype=torch.float32,
                                           block_k=fwd_block_k(d))):
        np.testing.assert_allclose(o.numpy(), o_j, **FP32)
        np.testing.assert_allclose(lse.numpy(), lse_j, **FP32)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    o_jb, lse_jb = jax_fwd(*(jnp.asarray(t.float().numpy())
                             for t in (qb, kb, vb)), causal=True,
                           window=window, block_q=64, block_k=64)
    o, lse = flash_attention_fwd_ref(qb, kb, vb, causal=True, window=window,
                                     operand_dtype=torch.bfloat16,
                                     block_k=fwd_block_k(d))
    o_jb = np.asarray(o_jb)
    assert (np.linalg.norm(o.float().numpy() - o_jb)
            / np.linalg.norm(o_jb)) <= 1e-2
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jb), atol=1e-5,
                               rtol=1e-6)


def test_decode_attention_d256_matches_pallas():
    """gemma3's dense decode head shape (G = 2, D = 256): lanes of valid
    length 0, 1, 100 and the whole ring, the plain version and the
    kernel's split form against the Pallas decode kernel (interpreted)
    and the oracle, fp32, within 2e-5."""
    rng = np.random.default_rng(7)
    b, h, kvh, s, d = 4, 4, 2, 192, 256
    q, k, v = _f32(rng, b, h, d), _f32(rng, b, kvh, s, d), \
        _f32(rng, b, kvh, s, d)
    vlen = np.asarray([0, s, 1, 100], np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, vlen)]
    pallas = np.asarray(ops.decode_attention(*jargs, block_s=64))
    oracle = np.asarray(ref.decode_attention_ref(*jargs))
    targs = [torch.from_numpy(a) for a in (q, k, v, vlen)]
    got = decode_attention(*targs)
    assert torch.equal(got, decode_attention_ref(*targs))
    np.testing.assert_allclose(got.numpy(), pallas, **FP32)
    np.testing.assert_allclose(got[1:].numpy(), oracle[1:], **FP32)
    for kps in (64, 128):
        np.testing.assert_allclose(
            decode_split_ref(*targs, keys_per_split=kps).numpy(), pallas,
            **FP32)


# ---------------------------------------------------------------------------
# the pure-global configs, and the three configs' sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "command-r-35b"])
def test_reduced_pure_global_paged_tokens_match_reference(arch):
    """Reduced pure-global stacks on the paged backend: prompts of 200 and
    700 tokens (native and chunked prefill), 6 new tokens; the port's
    tokens equal the reference's under the near-tie rule."""
    prompts = _prompts(2, 200, seed=3)[:1] + _prompts(1, 700, seed=4)
    want, params = _serve_jax(arch, "paged", prompts, 6)
    stats, got, margins = _serve(arch, "paged", prompts, 6, params)
    assert stats["completed"] == 2
    assert _near_tie_equal(want, got, margins) <= 1


@pytest.mark.parametrize("arch", ["gemma3-12b", "command-r-35b"])
def test_bridge_carries_qk_norm_and_tied_embedding(arch):
    """The reference's reduced weights cross the bridge whole: gemma3's
    q_norm/k_norm gains, a tied embedding (no separate unembedding) for
    both, no bias leaf anywhere, every leaf bit-equal."""
    from repro.models import ImplConfig, build_model
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = jax.tree.map(np.asarray, build_model(
        jcfg, ImplConfig(remat="none")).init_params(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, reduced_config(get_config(arch)),
                              "cpu")
    attn = next(iter(tparams["blocks"].values()))["attn"]
    assert ("q_norm" in attn and "k_norm" in attn) == (arch == "gemma3-12b")
    assert set(tparams["embed"]) == set(jparams["embed"]) == {"tok"}

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v

    want = dict(leaves(jparams))
    got = dict(leaves(tparams))
    assert set(got) == set(want) and not any("bias" in k for k in got)
    for key, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[key], np.float32))


@pytest.mark.parametrize("arch,lo,hi", [
    ("gemma3-12b", 9e9, 14e9), ("mistral-nemo-12b", 11e9, 14e9),
    ("command-r-35b", 28e9, 40e9)])
def test_full_width_param_counts_match_reference(arch, lo, hi):
    """The ranges of ``tests/test_arch_smoke.py``; the counts are exactly
    the reference's, and the reduced configs keep gemma's embedding
    scale."""
    n = model_param_count(get_config(arch))
    assert n == jax_param_count(jax_get_config(arch))
    assert lo <= n <= hi
    cfg = get_config(arch)
    assert cfg.scale_embed == arch.startswith("gemma")
    assert reduced_config(cfg).scale_embed == cfg.scale_embed
