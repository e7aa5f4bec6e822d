"""The port's global prefix cache against the JAX package's, on CPU.

Three layers, as the reference's ``tests/test_prefix_cache.py``:

* the trie: each of the reference's edge cases (empty prompt, sub-page
  prompt, divergence exactly at a page boundary and inside a partial
  page, racing inserts, refcount-0 LRU eviction that never takes pins,
  leaf-first eviction, the pod pool's global LRU across caches, flush)
  runs through both packages' ``PrefixCache``/``SharedPagePool``; the
  matches, freed page orders and stats must be EQUAL.  The hypothesis
  property runs on the port.
* the pool lifecycle: one sequence of grants, pins, donations, a
  copy-on-write grant, detaches, evictions under pressure and a drain
  through both packages' ``PagePool``; every free list, stat and request
  field EQUAL.
* integration: reduced tinyllama-1.1b through the port's ``Cluster``
  (``TorchExecutor(device="cpu")`` with the reference's weights) against
  the reference's (``JaxExecutor``), explicit prompts: warm, cold and
  dense tokens all equal each other and the reference's, with the same
  hit rate, copy-on-write count, cached pages and prefill pages; chunked
  long prompts; the dense backend's refusal; pod accounting; eviction
  under co-tenant pressure with pinned pages held.  Last, reduced
  mistral-nemo-12b at head dim 128, warm against cold against the
  reference's tokens.
"""

import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.history import HistoryStore as JaxHistory
from repro.models import ImplConfig, build_model
from repro.runtime import REDUCED_SHAPES as JAX_SHAPES
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import ServeOptions as JaxOpts
from repro.serving import kv_cache as jax_kv
from repro.serving import prefix_cache as jax_prefix
from repro.serving import tenancy as jax_tenancy
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.history import HistoryStore
from repro_torch.runtime import (REDUCED_SHAPES, Application, Cluster,
                                 ServeOptions, TorchExecutor)
from repro_torch.serving import kv_cache as torch_kv
from repro_torch.serving import prefix_cache as torch_prefix
from repro_torch.serving import tenancy as torch_tenancy

PAGE = torch_kv.PAGE_SIZE

JAX = types.SimpleNamespace(
    PrefixCache=jax_prefix.PrefixCache, SharedPagePool=jax_tenancy.SharedPagePool,
    PagePool=jax_kv.PagePool, Request=jax_kv.Request, History=JaxHistory)
PORT = types.SimpleNamespace(
    PrefixCache=torch_prefix.PrefixCache,
    SharedPagePool=torch_tenancy.SharedPagePool,
    PagePool=torch_kv.PagePool, Request=torch_kv.Request,
    History=HistoryStore)


def _toks(n, seed=0):
    return tuple((seed * 7919 + i * 31) % 211 for i in range(n))


def _match(m):
    return (list(m.phys_pages), m.cached_len, m.cow_src, len(m.nodes),
            m.hit)


# ---------------------------------------------------------------------------
# the trie: the reference's edge cases, each through both packages
# ---------------------------------------------------------------------------

def _cache(pkg):
    freed = []
    return pkg.PrefixCache(("test",), freed.extend), freed


def _empty_prompt(pkg):
    cache, _ = _cache(pkg)
    m = cache.pin(())
    assert not m.hit and m.cached_len == 0 and m.nodes == []
    return [_match(m), cache.unpin(m.nodes), cache.probe_new((), 0),
            cache.num_pages, dict(cache.stats)]


def _sub_page_prompt(pkg):
    cache, _ = _cache(pkg)
    toks = _toks(PAGE // 2)
    out = [_match(cache.pin(toks)), cache.probe_new(toks, 0)]
    created = cache.insert(toks, 0, [], partial_page=7)
    assert len(created) == 1 and not created[0].full
    m = cache.pin(toks)
    assert m.cached_len == len(toks) and m.phys_pages == [] and m.cow_src == 7
    out += [_match(m), cache.unpin(created + m.nodes), dict(cache.stats)]
    return out


def _boundary_divergence(pkg):
    cache, _ = _cache(pkg)
    base = _toks(2 * PAGE)
    donor = cache.insert(base, 0, [10, 11])
    m = cache.pin(base[:PAGE] + _toks(PAGE, seed=99))
    assert (m.cached_len, m.phys_pages, m.cow_src) == (PAGE, [10], None)
    return [_match(m), cache.unpin(donor + m.nodes), dict(cache.stats)]


def _partial_divergence(pkg):
    cache, _ = _cache(pkg)
    base = _toks(PAGE + 40)
    donor = cache.insert(base, 0, [3], partial_page=4)
    m = cache.pin(base[:PAGE + 25] + _toks(60, seed=5))
    assert (m.phys_pages, m.cached_len, m.cow_src) == ([3], PAGE + 25, 4)
    return [_match(m), cache.unpin(donor + m.nodes), dict(cache.stats)]


def _racing_inserts(pkg):
    cache, _ = _cache(pkg)
    toks = _toks(2 * PAGE + 30)
    m0, m1 = cache.pin(toks), cache.pin(toks)
    assert not m0.hit and not m1.hit
    out = [cache.probe_new(toks, 0)]
    created = cache.insert(toks, 0, [20, 21], partial_page=22)
    assert cache.probe_new(toks, 0) == (0, False), "raced insert adopts 0"
    m2 = cache.pin(toks)
    assert m2.phys_pages == [20, 21] and m2.cached_len == len(toks)
    out += [_match(m2), cache.unpin(created + m2.nodes), dict(cache.stats)]
    return out


def _lru_eviction(pkg):
    cache, freed = _cache(pkg)
    a = cache.insert(_toks(PAGE), 0, [1])
    b = cache.insert(_toks(PAGE, seed=2), 0, [2])
    assert cache.peek_evictable() is None, "pinned nodes are not candidates"
    out = [cache.evict_lru(need=4), list(freed)]
    cache.unpin(a)
    cache.unpin(b)
    out += [cache.evict_lru(need=1), list(freed)]
    assert freed == [1], "LRU order: the older unpinned node goes first"
    out += [cache.evict_lru(need=8), list(freed), cache.num_pages,
            dict(cache.stats)]
    return out


def _interior_nodes(pkg):
    cache, freed = _cache(pkg)
    chain = cache.insert(_toks(2 * PAGE + 10), 0, [5, 6], partial_page=7)
    cache.unpin(chain)
    cache.evict_lru(need=3)
    assert freed == [7, 6, 5]
    return [list(freed), dict(cache.stats)]


def _pod_global_lru(pkg):
    shared = pkg.SharedPagePool(8, history=pkg.History())
    ca = shared.prefix_cache(("a",),
                             lambda: pkg.PrefixCache(("a",), shared._give))
    cb = shared.prefix_cache(("b",),
                             lambda: pkg.PrefixCache(("b",), shared._give))
    toks = _toks(2 * PAGE)
    chain_a = ca.insert(toks, 0, shared._take(2))
    chain_b = cb.insert(toks, 0, shared._take(2))
    cb.unpin([chain_b[1]])
    ca.unpin([chain_a[1]])
    ca.unpin(ca.pin(toks).nodes)
    out = [sorted(shared.free)]
    got = shared._take(5)                 # shortfall of 1: evict ONE page
    assert chain_b[1] not in cb.nodes and chain_a[1] in ca.nodes
    out += [got, shared.stats["prefix_evictions"]]
    shared._give(got)
    got = shared._take(6)
    assert chain_a[1] not in ca.nodes
    out += [got, shared.stats["prefix_evictions"]]
    shared._give(got)
    assert shared._take(7) is None, "pinned heads are never stolen"
    out.append([n.refs for n in (chain_a[0], chain_b[0])])
    ca.unpin([chain_a[0]])
    cb.unpin([chain_b[0]])
    got = shared._take(8)
    assert ca.num_pages == 0 and cb.num_pages == 0
    out += [got, dict(shared.stats), dict(ca.stats), dict(cb.stats)]
    return out


def _flush(pkg):
    cache, freed = _cache(pkg)
    keep = cache.insert(_toks(PAGE), 0, [1])
    drop = cache.insert(_toks(PAGE, seed=3), 0, [2])
    cache.unpin(drop)
    out = [cache.flush(), list(freed), cache.num_pages]
    cache.unpin(keep)
    out += [cache.flush(), list(freed), dict(cache.stats)]
    assert freed == [2, 1]
    return out


@pytest.mark.parametrize("case", [
    _empty_prompt, _sub_page_prompt, _boundary_divergence,
    _partial_divergence, _racing_inserts, _lru_eviction, _interior_nodes,
    _pod_global_lru, _flush])
def test_trie_cases_match_reference(case):
    assert case(PORT) == case(JAX)


def test_lookup_of_inserted_prompt_matches_a_true_prefix():
    """The reference's hypothesis property, on the port: after inserting
    prompt ``p``, pinning any probe ``q`` yields cached tokens that are a
    common prefix of both, and the prompt itself is fully covered."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.given(
        p=st.lists(st.integers(0, 7), max_size=3 * PAGE + 9),
        q=st.lists(st.integers(0, 7), max_size=3 * PAGE + 9))
    @hypothesis.settings(max_examples=60, deadline=None)
    def prop(p, q):
        cache, _ = _cache(PORT)
        n_full, rem = len(p) // PAGE, len(p) % PAGE
        created = cache.insert(p, 0, list(range(n_full)),
                               partial_page=n_full if rem else None)
        m = cache.pin(q)
        assert m.cached_len <= len(q)
        assert tuple(q[:m.cached_len]) == tuple(p[:m.cached_len])
        m2 = cache.pin(p)
        assert m2.cached_len == len(p)
        cache.unpin(created + m.nodes + m2.nodes)

    prop()


# ---------------------------------------------------------------------------
# the pool lifecycle
# ---------------------------------------------------------------------------

def _donate(pool, cache, req, toks):
    """The runner's post-prefill donation (``_prefix_insert``), on the
    pool alone: full pages to the cache, the partial tail after a
    self-COW grant."""
    n_full, rem = req.prompt_len // PAGE, req.prompt_len % PAGE
    n_att = len(req.shared_pages)
    n_new, partial_new = cache.probe_new(toks, n_att)
    phys = []
    if n_new:
        phys = pool.cache_donate(req.pages[:n_new])
        del req.pages[:n_new]
        req.shared_pages.extend(phys)
    partial = None
    if partial_new and rem and n_att + n_new == n_full:
        got = pool.cow_grant()
        if got is not None:
            partial = pool.cache_donate(req.pages[:1])[0]
            req.pages[0] = got[0]
    if phys or partial is not None:
        req.prefix_nodes = (req.prefix_nodes or []) + cache.insert(
            toks, n_att, phys, partial_page=partial)
    return [n_new, partial_new, phys, partial]


def _req_state(r):
    return (list(r.pages), list(r.shared_pages), r.cached_len,
            r.cow_src_page, len(r.prefix_nodes or []), r.parked_shared,
            r.state)


def _pool_lifecycle(pkg):
    pool = pkg.PagePool(10, policy="fixed", fixed_init_pages=1,
                        fixed_step_pages=1)
    cache = pkg.PrefixCache(("k",), pool._give)
    pool.prefix_cache = cache
    shared = _toks(2 * PAGE + 30, seed=1)
    toks = [shared + _toks(60, seed=10 + i) for i in range(3)]
    reqs = [pkg.Request(f"r{i}", len(t), 4, prompt_tokens=t)
            for i, t in enumerate(toks)]
    out = []

    def attach(r):
        m = cache.pin(r.prompt_tokens, max_len=r.prompt_len - 1)
        r.prefix_nodes, r.shared_pages = m.nodes, list(m.phys_pages)
        r.cached_len, r.cow_src_page = m.cached_len, m.cow_src

    def snap(*extra):
        out.append([sorted(pool.free), dict(pool.stats), dict(cache.stats),
                    cache.num_pages] + [_req_state(r) for r in reqs]
                   + list(extra))

    attach(reqs[0])                       # miss
    assert pool.try_admit(reqs[0])
    snap(_donate(pool, cache, reqs[0], toks[0]))
    attach(reqs[1])                       # 2 full pages + a COW lead
    assert reqs[1].cow_src_page is not None
    snap(pool.try_admit(reqs[1]))
    snap(pool.grow(reqs[1], horizon=PAGE))
    pool.release(reqs[0])                 # unpins its chain
    snap()
    held = pool.reclaim(reqs[1])          # drained: the chain's last pin
    snap(held)
    snap(pool.regrant(reqs[1], len(held[0])))
    big = pkg.Request("big", 7 * PAGE, 4)
    snap(pool.try_admit(big))             # evicts refcount-0 nodes, LRU
    attach(reqs[2])                       # pins what is left of the chain
    snap(pool.try_admit(reqs[2]))         # denied: pins are never stolen
    pool.prefix_detach(reqs[2])
    snap()
    pool.release(big)
    pool.release(reqs[1])
    snap(cache.flush())
    return out


def test_page_pool_lifecycle_matches_reference():
    got = _pool_lifecycle(PORT)
    assert got == _pool_lifecycle(JAX)
    assert got[6][1]["prefix_evictions"] > 0 and got[7][-1] is False


# ---------------------------------------------------------------------------
# integration: reduced tinyllama-1.1b through both packages' Clusters
# ---------------------------------------------------------------------------

def _jax_params(cfg):
    """The reference's weights for ``cfg`` (its executors' init, seed 0),
    as numpy."""
    return jax.tree.map(np.asarray, build_model(
        cfg, ImplConfig(remat="none")).init_params(jax.random.PRNGKey(0)))


class BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights for its
    config name."""

    def __init__(self, params_by_name, **kw):
        super().__init__(**kw)
        self.params_by_name = params_by_name

    def init_params(self, handle):
        cfg = handle.app.config
        return params_from_jax(self.params_by_name[cfg.name], cfg,
                               self.device)


def _cluster(pkg, pool_pages, params=None):
    if pkg is JAX:
        return JaxCluster(pods=1, history=JaxHistory(),
                          executor=JaxExecutor(seed=0),
                          pool_pages=pool_pages)
    return Cluster(history=HistoryStore(), pool_pages=pool_pages,
                   executor=BridgedExecutor(params, device="cpu"))


def _mk_handle(pkg, cluster, name, *, arch="tinyllama-1.1b",
               backend="paged", prefix=False, **opts):
    """The reference test's app: reduced ``arch`` (a config name, or a
    reduced config given whole), max batch 2, fixed sizing."""
    app, opts_cls = (JaxApp, JaxOpts) if pkg is JAX else (Application,
                                                          ServeOptions)
    so = opts_cls(max_batch=2, backend=backend, policy="fixed",
                  cache_len=1024, prefix_cache=prefix, **opts)
    if isinstance(arch, str):
        return cluster.submit(app.serve(arch, reduced=True, name=name,
                                        serve=so))
    shapes = JAX_SHAPES if pkg is JAX else REDUCED_SHAPES
    return cluster.submit(app.serve(arch, shape=shapes["decode"], name=name,
                                    serve=so))


def _overlap_requests(pkg, n, *, shared_len=2 * PAGE + 25, suffix_len=70,
                      gen=6):
    shared = _toks(shared_len, seed=1)
    reqs = []
    for i in range(n):
        toks = shared + _toks(suffix_len, seed=100 + i)
        reqs.append(pkg.Request(f"px{i}", len(toks), gen,
                                prompt_tokens=toks))
    return reqs


def _serve_seq(h, reqs):
    """One request at a time (a deterministic hit pattern: no insert
    race)."""
    out = []
    for r in reqs:
        h.submit_request(r)
        while h.step()["alive"]:
            pass
        out.append(tuple(r.output_tokens))
    return out


def _stats(pkg, h):
    return (h.serving_stats() if pkg is JAX
            else h.stats_view.cumulative())


PREFIX_KEYS = ("prefix_hit_rate", "prefix_lookups", "prefix_hits",
               "cow_copies", "shared_pages", "prefill_pages_computed")


@pytest.fixture(scope="module")
def tiny_params():
    return {"tinyllama-1.1b": _jax_params(jax_reduced(
        jax_get_config("tinyllama-1.1b")))}


@pytest.fixture(scope="module")
def warm_cold_dense(tiny_params):
    """The reference's warm/cold/dense arms (3 overlapping prompts, one
    at a time, pool of 64) through both packages: {pkg: {arm: (tokens,
    stats)}}."""
    out = {}
    for pkg in (JAX, PORT):
        arms = {}
        for arm, (backend, prefix) in (("warm", ("paged", True)),
                                       ("cold", ("paged", False)),
                                       ("dense", ("dense", False))):
            cluster = _cluster(pkg, 64, tiny_params)
            h = _mk_handle(pkg, cluster, f"parity-{arm}", backend=backend,
                           prefix=prefix)
            toks = _serve_seq(h, _overlap_requests(pkg, 3))
            arms[arm] = (toks, _stats(pkg, h))
            h.release()
        out["jax" if pkg is JAX else "port"] = arms
    return out


def test_warm_cold_dense_tokens_equal_each_other_and_the_reference(
        warm_cold_dense):
    """Reusing cached prefix KV and copy-on-write partial pages changes
    which pages prefill computes, never the tokens: the port's warm, cold
    and dense arms give the same tokens, equal to the reference's."""
    port, ref = warm_cold_dense["port"], warm_cold_dense["jax"]
    assert port["warm"][0] == port["cold"][0] == port["dense"][0]
    assert port["warm"][0] == ref["warm"][0] == ref["dense"][0]


@pytest.mark.parametrize("key", PREFIX_KEYS)
def test_warm_prefix_stats_match_reference(warm_cold_dense, key):
    """The warm arm's prefix counters are the reference's: hit rate 2/3,
    at least one copy-on-write, cached pages, and fewer prefill pages
    computed than the cold arm (which computes the same count as the
    reference's cold arm)."""
    port, ref = warm_cold_dense["port"], warm_cold_dense["jax"]
    assert port["warm"][1][key] == ref["warm"][1][key]
    warm = port["warm"][1]
    assert warm["prefix_hit_rate"] == pytest.approx(2 / 3)
    assert warm["cow_copies"] > 0 and warm["shared_pages"] > 0
    assert (warm["prefill_pages_computed"]
            < port["cold"][1]["prefill_pages_computed"]
            == ref["cold"][1]["prefill_pages_computed"])


def test_chunked_prefill_matches_dense_and_reference(tiny_params):
    """Prompts of 5 pages + 17 tokens run chunked prefill without a cache
    (chunks of 4 pages on the absolute grid: 2 a prompt): paged tokens
    equal dense tokens and the reference's."""
    outs = {}
    for pkg in (JAX, PORT):
        for backend in ("paged", "dense"):
            reqs = [pkg.Request(f"lg{i}", 5 * PAGE + 17, 5,
                                prompt_tokens=_toks(5 * PAGE + 17,
                                                    seed=40 + i))
                    for i in range(2)]
            cluster = _cluster(pkg, 64, tiny_params)
            h = _mk_handle(pkg, cluster, f"chunk-{backend}", backend=backend)
            outs[pkg is JAX, backend] = _serve_seq(h, reqs)
            if pkg is PORT and backend == "paged":
                assert h.runner.prefill_chunks == 4
                assert h.runner.prefill_pages_computed == 12
            h.release()
    assert len({tuple(v) for v in outs.values()}) == 1


def test_dense_backend_rejects_prefix_cache():
    """Dense KV has no page identity to share: the typed options refuse
    the combination before any bind (so no pool view leaks), and
    ``build_runner`` refuses it for direct callers, as the reference."""
    from repro_torch.serving.model_runner import build_runner
    with pytest.raises(ValueError, match="no shareable page identity"):
        build_runner("dense", reduced_config(get_config("tinyllama-1.1b")),
                     prefix_cache=torch_prefix.PrefixCache(
                         ("x",), lambda pages: None), device="cpu")
    cluster = Cluster(history=HistoryStore(), pool_pages=32,
                      executor=TorchExecutor(device="cpu"))
    with pytest.raises(ValueError, match="page identity"):
        _mk_handle(PORT, cluster, "dense-reject", backend="dense",
                   prefix=True)
    assert not cluster.pod_pool("pod0").views, \
        "failed construction leaked a pool view"


def _pod_accounting(pkg, params):
    cluster = _cluster(pkg, 64, params)
    h = _mk_handle(pkg, cluster, "quota", prefix=True)
    toks = _serve_seq(h, _overlap_requests(pkg, 2))
    pool = h.engine.pool
    shared, cache = pool.shared, h.runner.prefix
    out = [toks, cache.num_pages, pool.used, shared.used_pages,
           shared.utilization]
    assert cache.num_pages > 0 and pool.used == 0
    assert shared.used_pages == cache.num_pages, \
        "cache-owned pages stay charged at pod level"
    h.release()
    assert shared.used_pages == 0, \
        "last user's release flushes the cache with its page tensors"
    return out + [shared.used_pages, dict(shared.stats)]


def test_cache_pages_out_of_quota_but_in_pod_accounting(tiny_params):
    """Donated pages leave the view's quota charge but stay in the pod's
    used pages (cache-owned, not free); the last user's release flushes
    them and drops the store's tensors -- as the reference accounts."""
    got = _pod_accounting(PORT, tiny_params)
    assert got == _pod_accounting(JAX, tiny_params)


def _eviction_run(pkg, params, pressure):
    """The reference's scenario: 14 pages; a greedy co-tenant's two
    concurrent 6-page requests overshoot the free list left by the pinned
    cache chain and a mid-decode request, forcing refcount-0 eviction,
    while any single request still fits."""
    cluster = _cluster(pkg, 14, params)
    a = _mk_handle(pkg, cluster, "cached-a", prefix=True)
    outs = _serve_seq(a, _overlap_requests(pkg, 2, gen=4))
    ra = _overlap_requests(pkg, 1, gen=8)[0]
    ra.req_id = "under-pressure"
    evicted = 0
    if pressure:
        shared = cluster.pod_pool("pod0")
        assert shared.used_pages > 0          # idle cache pages held
        b = _mk_handle(pkg, cluster, "greedy-b", quota_pages=14)
        a.submit_request(ra)
        a.step()                              # pin + prefill, mid-decode
        for i in range(3):
            b.submit_request(pkg.Request(f"big{i}", 5 * PAGE, 4,
                                         prompt_tokens=_toks(5 * PAGE,
                                                             seed=60 + i)))
        while b.step()["alive"]:
            pass
        while a.step()["alive"]:
            pass
        outs.append(tuple(ra.output_tokens))
        evicted = shared.stats["prefix_evictions"]
        b.release()
    else:
        outs.extend(_serve_seq(a, [ra]))
    a.release()
    return outs, evicted


def test_eviction_under_cotenant_pressure_holds_pins(tiny_params):
    """Co-tenant demand reclaims idle cache pages (refcount-0 LRU) but
    never the chain a request decodes through: tokens under pressure
    equal the calm run's and the reference's, with the reference's
    eviction count."""
    calm, _ = _eviction_run(PORT, tiny_params, False)
    pressured, evicted = _eviction_run(PORT, tiny_params, True)
    want, want_evicted = _eviction_run(JAX, tiny_params, True)
    assert evicted > 0, "co-tenant demand must reclaim idle cache pages"
    assert pressured == calm == want and evicted == want_evicted


def test_reduced_mistral_d128_warm_cold_match_reference():
    """Reduced mistral-nemo-12b with head dim 128 (the full width's): the
    warm arm's tokens equal the cold arm's and the reference's warm
    arm's, with the reference's prefix counters."""
    jcfg = jax_reduced(jax_get_config("mistral-nemo-12b"), head_dim=128)
    cfg = reduced_config(get_config("mistral-nemo-12b"), head_dim=128)
    params = {cfg.name: _jax_params(jcfg)}
    got = {}
    for pkg, arch in ((JAX, jcfg), (PORT, cfg)):
        for prefix in (True, False):
            cluster = _cluster(pkg, 64, params)
            h = _mk_handle(pkg, cluster, f"mistral-{prefix}", arch=arch,
                           prefix=prefix)
            assert h.runner.cfg.head_dim == 128
            toks = _serve_seq(h, _overlap_requests(pkg, 3, gen=5))
            stats = _stats(pkg, h)
            got[pkg is JAX, prefix] = (toks, [stats.get(k)
                                              for k in PREFIX_KEYS])
            h.release()
    assert got[False, True][0] == got[False, False][0] == got[True, True][0]
    assert got[False, True][1] == got[True, True][1]
