"""The port's serving slice against the JAX package's, on CPU.

The slice as a whole: reduced tinyllama-1.1b served by the reference's
``PagedRunner`` + ``ServingEngine`` + ``PagePool(policy="fixed")`` and by
the port, on bridged weights and explicit prompts of 200 and 700 tokens
(native and chunked prefill), 6 new tokens each.  Greedy tokens must be
equal, except that a request may diverge at a step where the port's top-2
logit gap is below ``TIE_GAP`` (the two frameworks round bf16 at slightly
different places, which can flip a near-tie); the test asserts that rule
explicitly.  Also the copied control plane (pool, engine) against the
reference's on the same request mixes.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kv_cache import PagePool as JaxPool
from repro.serving.kv_cache import Request as JaxRequest
from repro.serving.model_runner import build_runner as jax_build_runner
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_LOCAL, MAMBA2, RWKV6
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import (PAGE_SIZE, PagePool, Request,
                                         page_table, pool_pages_for_budget)
from repro_torch.serving.model_runner import PagedRunner, build_runner

TIE_GAP = 1e-2


def _serve_jax(cfg, prompts, max_new):
    runner = jax_build_runner("paged", cfg, seed=0, max_batch=4,
                              pool_pages=32)
    eng = JaxEngine(JaxPool(32, policy="fixed"), max_batch=4, runner=runner)
    reqs = [JaxRequest(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    return runner, {r.req_id: r.output_tokens for r in reqs}


def test_reduced_tinyllama_serve_matches_reference():
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    tcfg = reduced_config(get_config("tinyllama-1.1b"))
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, tcfg.vocab_size, n))
               for n in (200, 700)]
    jrunner, want = _serve_jax(jcfg, prompts, 6)

    params = params_from_jax(jax.tree.map(np.asarray, jrunner.params), tcfg,
                             "cpu")
    runner = PagedRunner(tcfg, pool_pages=32, max_batch=4, params=params,
                         device="cpu", record_margins=True)
    eng = ServingEngine(PagePool(32, policy="fixed"), max_batch=4,
                        runner=runner)
    reqs = [Request(f"r{i}", len(p), 6, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_to_completion(max_steps=500)
    got = {r.req_id: r.output_tokens for r in reqs}

    assert stats.completed == 2 and all(len(t) == 7 for t in got.values())
    # 200 tokens = 2 pages: native; 700 = 6 pages: chunks of 4 + 2
    assert runner.prefill_chunks == 1 + 2
    flips = 0
    for rid, w in want.items():
        for j, (a, b) in enumerate(zip(w, got[rid])):
            if a != b:
                gap = runner.margins[rid][j]
                assert gap < TIE_GAP, (
                    f"{rid} token {j}: port {b} vs reference {a} at a "
                    f"top-2 logit gap of {gap:.3e} (>= {TIE_GAP})")
                flips += 1
                break
    assert flips <= 1, f"{flips} near-tie divergences in 2 requests"


# ---------------------------------------------------------------------------
# the copied control plane against the reference's
# ---------------------------------------------------------------------------

def _drive(engine_cls, pool_cls, req_cls, *, pages, specs, policy, init,
           step, max_batch):
    pool = pool_cls(pages, policy=policy, fixed_init_pages=init,
                    fixed_step_pages=step)
    eng = engine_cls(pool, max_batch=max_batch)
    for i, (plen, new) in enumerate(specs):
        eng.submit(req_cls(f"r{i}", plen, new))
    stats = eng.run_to_completion(max_steps=10_000)
    keys = ("admitted", "completed", "rejected", "preempted",
            "decode_steps", "prefills", "tokens_generated")
    return ({k: getattr(stats, k) for k in keys},
            dict(pool.stats), sorted(pool.free))


@pytest.mark.parametrize("pages,policy,init,step,max_batch", [
    (64, "fixed", 1, 1, 4),          # roomy: no pressure
    (9, "fixed", 2, 1, 4),           # preemption under pressure
    (16, "history", 2, 1, 3),        # the sizing solve (empty history)
    (4, "fixed", 1, 1, 4),           # one request can never fit
])
def test_engine_and_pool_match_reference(pages, policy, init, step,
                                         max_batch):
    rng = np.random.default_rng(pages)
    specs = [(int(rng.integers(1, 400)), int(rng.integers(1, 200)))
             for _ in range(10)]
    if pages == 4:
        specs.append((600, 10))
    kw = dict(pages=pages, specs=specs, policy=policy, init=init,
              step=step, max_batch=max_batch)
    want = _drive(JaxEngine, JaxPool, JaxRequest, **kw)
    got = _drive(ServingEngine, PagePool, Request, **kw)
    assert got[0] == want[0]
    assert got[2] == want[2] == list(range(pages))
    for k, v in got[1].items():
        assert want[1][k] == v, k


@pytest.mark.parametrize("policy", ["history", "peak"])
def test_sizing_from_history_matches_reference(policy):
    """The pool reads a history store through ``get``/``observe`` (the
    reference's ``HistoryStore`` API): the same observed request sizes
    give the same init/step as the reference's pool, and a release is
    recorded back into the store."""
    from repro.core.history import HistoryStore
    hist = HistoryStore()
    rng = np.random.default_rng(5)
    for v in rng.integers(1, 12, 60):
        hist.observe("serve", "request", "pages", int(v))
    want = JaxPool(1024, history=hist, policy=policy).sizing()
    pool = PagePool(1024, history=hist, policy=policy)
    got = pool.sizing()
    assert (got.init, got.step) == (want.init, want.step)
    fresh = HistoryStore()
    pool = PagePool(8, history=fresh, policy=policy)
    r = Request("a", prompt_len=PAGE_SIZE * 3, max_new_tokens=1)
    assert pool.try_admit(r)
    assert fresh.get("serve", "request", "pages") is None
    pool.release(r)
    assert fresh.get("serve", "request", "pages").peak() >= 3


def test_pool_admit_grow_release():
    pool = PagePool(32, policy="fixed", fixed_init_pages=2,
                    fixed_step_pages=1)
    r = Request("a", prompt_len=100, max_new_tokens=300)
    assert pool.try_admit(r) and len(r.pages) == 2
    r.generated = 2 * PAGE_SIZE
    assert pool.grow(r, horizon=1) and len(r.pages) == r.pages_needed(1)
    pool.release(r)
    assert sorted(pool.free) == list(range(32)) and r.state == "done"


def test_page_table_and_budget():
    reqs = [Request("a", 1, 1, pages=[3, 1]), Request("b", 1, 1, pages=[7])]
    np.testing.assert_array_equal(page_table(reqs, 3),
                                  [[3, 1, -1], [7, -1, -1]])
    np.testing.assert_array_equal(page_table(reqs, 2, pages=[[5], [6, 2]]),
                                  [[5, -1], [6, 2]])
    per_page = 2 * PAGE_SIZE * 256 * 2 * 22
    assert pool_pages_for_budget(per_page * 10, 22, 256) == 10


@pytest.mark.parametrize("policy", ["history", "peak"])
def test_engine_and_pool_with_history_match_reference(policy):
    """Engine + pool with a history store, each package with its own
    ``HistoryStore``: two rounds of one request trace (the second sized
    from the first's observations, under the app's ``history_key``) give
    the same grants, scale-ups, stats and histories as the reference.
    Exact equality."""
    from repro.core.history import HistoryStore as JaxHistory
    from repro_torch.core.history import HistoryStore
    rng = np.random.default_rng(11)
    specs = [(int(rng.integers(1, 500)), int(rng.integers(1, 300)))
             for _ in range(12)]

    def rounds(engine_cls, pool_cls, req_cls, hist):
        out = []
        for rnd in range(2):
            pool = pool_cls(24, history=hist, app="app@r1", policy=policy)
            pool.history_key = "app"
            eng = engine_cls(pool, max_batch=3, history=hist)
            for i, (plen, new) in enumerate(specs):
                eng.submit(req_cls(f"q{rnd}.{i}", plen, new))
            stats = eng.run_to_completion(max_steps=10_000)
            sz = pool.sizing()
            out.append(({k: getattr(stats, k) for k in stats.COUNTERS
                         if not k.endswith("_s_sum")},
                        {k: pool.stats[k] for k in ("grants", "grant_pages",
                                                    "denials", "scaleups",
                                                    "released")},
                        (sz.init, sz.step), sorted(pool.free)))
        h = hist.get("app", "request", "pages")
        assert hist.get("app@r1", "request", "pages") is None
        return out, (h.count, h.weights)

    want = rounds(JaxEngine, JaxPool, JaxRequest, JaxHistory())
    got = rounds(ServingEngine, PagePool, Request, HistoryStore())
    assert got == want
    (first, second), _ = got
    assert second[2] != first[2], "the second round is sized from history"


# ---------------------------------------------------------------------------
# the port's runner on its own (CPU, plain kernel versions)
# ---------------------------------------------------------------------------

def _cfg():
    return reduced_config(get_config("tinyllama-1.1b"))


def test_runner_refuses_what_later_slices_bring():
    """The dense backend serves (``test_torch_dense.py``), and so do
    sliding-window stacks on both backends (``test_torch_rings.py``); what
    still raises: a sliding-window layer without a window, the prefix
    cache on either backend, and training the recurrent families."""
    cfg = _cfg()
    local = cfg.scaled(pattern=(ATTN_LOCAL,), sliding_window=8)
    assert PagedRunner(local, device="cpu").use_rings
    assert build_runner("dense", local, device="cpu").cache[
        "p0_attn_local"]["k"].shape[3] == 8
    with pytest.raises(ValueError, match="sliding_window"):
        PagedRunner(local.scaled(sliding_window=0), device="cpu")
    with pytest.raises(ValueError, match="prefix cache"):
        PagedRunner(cfg, prefix_cache=object(), device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        build_runner("dense", cfg, prefix_cache=object(), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        build_runner("sparse", cfg, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        PagedRunner(cfg.scaled(rope_theta=0.0), device="cpu")
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    for kind in (MAMBA2, RWKV6):
        with pytest.raises(ValueError, match="training a .* later slice"):
            T.apply_block_train(cfg, kind, {}, x)


def test_paged_preemption_readmission_and_state_eviction():
    """Prompt 200 = 2 pages; growth past token 256 in a full 8-page pool
    forces preemption and a re-prefill into other pages.  Completed
    requests own their tokens and leave nothing in the runner."""
    runner = build_runner("paged", _cfg(), pool_pages=8, max_batch=4,
                          device="cpu")
    eng = ServingEngine(PagePool(8, policy="fixed"), max_batch=4,
                        runner=runner)
    reqs = [Request(f"r{i}", 200, 60) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_to_completion(max_steps=5000)
    assert stats.preempted >= 1, "scenario must exercise preemption"
    assert stats.completed == 4
    assert all(len(r.output_tokens) == 61 for r in reqs)
    assert runner.generated == {}
    assert sorted(eng.pool.free) == list(range(8))


def test_synthesized_prompts_are_stable():
    from repro_torch.serving.model_runner import synth_prompt
    a = synth_prompt("req-7", 50, 256)
    assert a.shape == (1, 50) and int(a.max()) < 256
    assert a.equal(synth_prompt("req-7", 50, 256))
    assert not a.equal(synth_prompt("req-8", 50, 256))
