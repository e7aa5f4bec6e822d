"""zensan over the port, held against the reference's sanitizer.

The reference's cases (``tests/test_zensan.py``) on the port's pools:
the sanitizer stays silent on every legal flow, catches each seeded
corruption by the reference's rule name, costs nothing when disabled,
and adopts a live pool when enabled mid-flight.  Held against the
reference: ``explore(depth=3)`` of both packages gives equal counts and
violations, and a recording subclass of each package's ``Sanitizer``
logs the same hook calls (name, owning app, page ids and counts as
plain ints) on a model-free two-tenant flow and on a ``Cluster`` flow
(reduced tinyllama-1.1b, paged, prefix cache, a co-tenant, a park and
an unpark).
"""

import types

import pytest

from repro.analysis import zensan as jax_zensan
from repro.core.history import HistoryStore as JaxHistory
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import ServeOptions as JaxOpts
from repro.serving import kv_cache as jax_kv
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serving.tenancy import SharedPagePool as JaxShared
from repro_torch.analysis import zensan
from repro_torch.analysis.zensan import ZensanViolation
from repro_torch.core.history import HistoryStore
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
from repro_torch.serving.kv_cache import PAGE_SIZE, PagePool, Request
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.tenancy import SharedPagePool

JAX = types.SimpleNamespace(
    zensan=jax_zensan, Shared=JaxShared, Prefix=JaxPrefixCache,
    Request=jax_kv.Request, History=JaxHistory, Cluster=JaxCluster,
    App=JaxApp, Opts=JaxOpts, executor=lambda: JaxExecutor(seed=0))
PORT = types.SimpleNamespace(
    zensan=zensan, Shared=SharedPagePool, Prefix=PrefixCache,
    Request=Request, History=HistoryStore, Cluster=Cluster,
    App=Application, Opts=ServeOptions,
    executor=lambda: TorchExecutor(device="cpu", seed=0))


@pytest.fixture
def san():
    """Strict sanitizer for the test body; restores whatever was
    installed before (a ``REPRO_ZENSAN=1`` instance, usually None)."""
    prev = zensan.SAN
    s = zensan.enable(strict=True)
    yield s
    zensan._install(prev)


@pytest.fixture
def lax():
    """Non-strict: accumulate violations for inspection."""
    prev = zensan.SAN
    s = zensan.enable(strict=False)
    yield s
    zensan._install(prev)


def _pod(pages=16, apps=("a", "b")):
    shared = SharedPagePool(pages, history=HistoryStore())
    views = {app: shared.view(app, policy="fixed", fixed_init_pages=1,
                              fixed_step_pages=1) for app in apps}
    return shared, views


def _req(rid, pages=1, max_new=4):
    toks = tuple(range(pages * PAGE_SIZE))
    return Request(rid, len(toks), max_new_tokens=max_new,
                   prompt_tokens=toks)


# -- clean flows stay silent --------------------------------------------------

def test_clean_two_tenant_flow(san):
    shared, views = _pod()
    reqs = {}
    for app, v in views.items():
        r = _req(f"{app}0", pages=2)
        assert v.try_admit(r)
        reqs[app] = r
        san.check(v)
    for _ in range(3):                      # grow + check each step
        for app, v in views.items():
            v.grow(reqs[app], horizon=1)
            san.check(v)
    va = views["a"]                         # park/unpark round trip
    phys, phys_local = va.reclaim(reqs["a"])
    va.parked = True
    san.check(va)
    va.parked = False
    assert va.regrant(reqs["a"], len(phys), len(phys_local))
    san.unpark_done(va, "a")
    san.check(va)
    for app, v in views.items():
        v.release(reqs[app])
        san.check(v)
        v.close()
    assert san.violations == [] and san.events > 0


def test_clean_null_engine_serving(san):
    """End to end through the port's Cluster/ServingEngine with the null
    executor: every step's quiescent check stays green."""
    from repro_torch.runtime import NullExecutor

    cluster = Cluster(pods=1, history=HistoryStore(),
                      executor=NullExecutor(), pool_pages=16)
    h = cluster.submit(Application.serve(
        "tinyllama-1.1b", reduced=True, name="zs",
        serve=ServeOptions(max_batch=2)))
    for i in range(3):
        h.submit_request(Request(f"r{i}", PAGE_SIZE - 4, 6))
    for _ in range(200):
        if not h.step()["alive"]:
            break
    h.park()
    h.unpark()
    h.release()
    assert san.violations == [] and san.events > 0


def test_clean_private_pool_prefix_flow(san):
    pool = PagePool(8, app="solo")
    pool.prefix_cache = PrefixCache(("solo",), pool._give)
    r = _req("p0", pages=2)
    assert pool.try_admit(r)
    phys = pool.cache_donate(r.pages[:1])
    del r.pages[:1]
    r.shared_pages = phys
    created = pool.prefix_cache.insert(r.prompt_tokens[:PAGE_SIZE], 0, phys)
    r.prefix_nodes = created
    san.check(pool)
    pool.release(r)
    san.check(pool)
    pool.prefix_cache.flush()
    san.check(pool)
    assert san.violations == []


# -- seeded corruptions are caught by the reference's rule names -------------

def test_seeded_double_free(san):
    shared, views = _pod()
    v = views["a"]
    r = _req("df0", pages=2)
    assert v.try_admit(r)
    phys = v.to_physical(r.pages)
    v.release(r)                            # legal free
    with pytest.raises(ZensanViolation, match=r"double-free"):
        shared._give(phys)                  # the bug: freed again


def test_seeded_refcount_leak(san):
    pool = PagePool(8, app="leak")
    pool.prefix_cache = PrefixCache(("leak",), pool._give)
    r = _req("rl0", pages=1)
    assert pool.try_admit(r)
    phys = pool.cache_donate(list(r.pages))
    r.pages = []
    node = pool.prefix_cache.insert(r.prompt_tokens, 0, phys)[0]
    node.refs += 1                          # the bug: a pin bypassing pin()
    with pytest.raises(ZensanViolation, match=r"refcount-leak"):
        san.check(pool)


def test_seeded_quota_overdraft(san, monkeypatch):
    from repro_torch.serving import tenancy

    def buggy_alloc(self, n):
        """PoolView._alloc with its quota guard deleted."""
        got = self.shared._take(n)
        if got is None:
            return None
        self.used += n
        ids = self._new_ids(n)
        for vid, pid in zip(ids, got):
            self._remap[vid] = pid
        s = zensan.SAN
        if s is not None:
            s.grant(self, ids, got)
        return ids

    monkeypatch.setattr(tenancy.PoolView, "_alloc", buggy_alloc)
    shared = SharedPagePool(16, history=HistoryStore())
    v = shared.view("a", quota=2, policy="fixed", fixed_init_pages=1,
                    fixed_step_pages=1)
    with pytest.raises(ZensanViolation, match=r"quota-overdraft"):
        v.try_admit(_req("qo0", pages=3))


def test_seeded_stranded_park_receipt(san):
    shared, views = _pod()
    v = views["a"]
    r = _req("sp0", pages=2)
    assert v.try_admit(r)
    phys, _ = v.reclaim(r)                  # park receipt recorded
    assert len(phys) == 2
    with pytest.raises(ZensanViolation, match=r"stranded-park-receipt"):
        san.unpark_done(v, "a")             # ...but never regranted


def test_seeded_park_mismatch(san):
    shared, views = _pod()
    v = views["a"]
    r = _req("pm0", pages=2)
    assert v.try_admit(r)
    phys, _ = v.reclaim(r)
    with pytest.raises(ZensanViolation, match=r"park-mismatch"):
        v.regrant(r, len(phys) + 1)         # the bug: wrong page count


def test_seeded_id_escape(san):
    """A view-local id reaching a decode table (the runtime twin of
    zenlint ZL001) is flagged against the ledger."""
    shared, views = _pod()
    v = views["a"]
    r = _req("ie0", pages=1)
    assert v.try_admit(r)
    with pytest.raises(ZensanViolation, match=r"id-escape"):
        san.table(v, [list(r.pages)], [])   # untranslated view-local ids
    san.table(v, [v.to_physical(r.pages)], [])  # the translated row is fine


def test_seeded_view_leak(san):
    shared, views = _pod()
    v = views["a"]
    assert v.try_admit(_req("vl0", pages=2))
    with pytest.raises(ZensanViolation, match=r"view-leak"):
        v.close()                           # the bug: close holding pages


def test_seeded_conservation_diff(lax):
    """A page silently dropped from a view's remap shows up in the
    check() sweep with the ledger-vs-real diff attached."""
    shared, views = _pod()
    v = views["a"]
    r = _req("cv0", pages=2)
    assert v.try_admit(r)
    lax.check(v)
    assert lax.violations == []
    v._remap.popitem()                      # the bug: lost a page
    lax.check(v)
    assert "conservation" in {x.rule for x in lax.violations}
    assert any("ledger" in x.diff for x in lax.violations if x.diff)


def test_seeded_dense_slot(san):
    runner = types.SimpleNamespace(slots={}, generated={})
    with pytest.raises(ZensanViolation, match=r"dense-slot"):
        san.dense_state(runner, [_req("ds0")])


# -- bounded schedule explorer ------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3])
def test_explorer_clean(depth):
    prev = zensan.SAN
    res = zensan.explore(depth=depth)
    assert zensan.SAN is prev               # save/restore held
    assert res.sequences == len(zensan.EXPLORE_OPS) ** depth
    assert res.ops_applied == res.sequences * depth
    assert res.ok, "\n".join(v.render() for v in res.violations[:10])


def test_explorer_catches_seeded_model_bug(monkeypatch):
    """The explorer is not vacuously green: a model whose preempt
    double-charges the quota trips the ledger."""
    from repro_torch.serving import tenancy

    real_dealloc = tenancy.PoolView._dealloc

    def buggy_dealloc(self, pages):
        self.used += len(pages)             # the bug: double-charge
        return real_dealloc(self, pages)

    monkeypatch.setattr(tenancy.PoolView, "_dealloc", buggy_dealloc)
    res = zensan.explore(depth=2, ops=("grant_a", "preempt_a"))
    assert not res.ok
    assert any(v.rule == "conservation" for v in res.violations)


def test_explorer_matches_reference():
    """``explore(depth=3)`` of both packages: equal schedule counts, ops
    applied and violations (rule and message)."""
    got, want = zensan.explore(depth=3), jax_zensan.explore(depth=3)
    assert (got.depth, got.sequences, got.ops_applied) == (
        want.depth, want.sequences, want.ops_applied)
    assert [(v.rule, v.message) for v in got.violations] == [
        (v.rule, v.message) for v in want.violations]


# -- disabled: zero footprint -------------------------------------------------

def test_disabled_leaves_no_shadow_state():
    prev = zensan.SAN
    zensan._install(None)
    try:
        shared, views = _pod()
        v = views["a"]
        r = _req("z0", pages=2)
        assert v.try_admit(r)
        v.release(r)
        assert not hasattr(shared, "_zs_ledger")
        assert not hasattr(v, "_zs_local")
    finally:
        zensan._install(prev)


def test_enable_mid_flight_adopts_live_state():
    """enable() after unobserved mutations must re-snapshot, not
    complain about history it never saw."""
    prev = zensan.SAN
    zensan._install(None)
    try:
        shared, views = _pod()
        v = views["a"]
        r = _req("mf0", pages=2)
        assert v.try_admit(r)               # unobserved
        s = zensan.enable(strict=True)
        r2 = _req("mf1", pages=1)
        assert v.try_admit(r2)
        s.check(v)
        v.release(r)
        v.release(r2)
        s.check(v)
        assert s.violations == []
    finally:
        zensan._install(prev)


# -- hook logs held against the reference ------------------------------------

HOOKS = ("take", "give", "grant", "release", "cache_donated", "grant_local",
         "release_local", "pinned", "unpinned", "inserted", "evicted",
         "parked", "regranted", "park_cancel", "unpark_done", "table",
         "dense_state", "view_closed", "check")


def _plain(x):
    """A hook argument as plain data: a pool or view as its app, a cache
    as its key, a prefix node as its page, requests as their ids, page
    ids and counts as ints."""
    if x is None or isinstance(x, (str, int)):
        return x
    if hasattr(x, "nodes") and hasattr(x, "key"):         # a prefix cache
        return ("cache", tuple(x.key))
    if hasattr(x, "page") and hasattr(x, "refs"):         # a prefix node
        return ("node", int(x.page))
    if hasattr(x, "req_id"):
        return x.req_id
    if hasattr(x, "slots") and hasattr(x, "generated"):   # a dense runner
        return "runner"
    if hasattr(x, "free"):                                # a pool or view
        return ("pool", getattr(x, "app", None))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(e) for e in x)
    return int(x)


def _recorder(mod):
    """A strict sanitizer of ``mod`` that logs every hook call."""
    class Recording(mod.Sanitizer):
        def __init__(self):
            super().__init__(strict=True)
            self.log = []

    def wrap(name):
        base = getattr(mod.Sanitizer, name)

        def hook(self, *args):
            self.log.append((name,) + tuple(_plain(a) for a in args))
            return base(self, *args)
        return hook

    for name in HOOKS:
        setattr(Recording, name, wrap(name))
    return Recording()


def _logged(pkg, flow):
    prev = pkg.zensan.SAN
    rec = _recorder(pkg.zensan)
    pkg.zensan._install(rec)
    try:
        flow(pkg)
    finally:
        pkg.zensan._install(prev)
    assert rec.violations == []
    return rec.log


def _model_free_flow(pkg):
    """Two tenants on one pod pool and one prefix cache: a's prompt is
    pinned (a miss), admitted and donated to the cache; b pins a's
    donated page and is admitted; a second request of a is preempted; a
    is parked and unparked; b completes, its pin is dropped and the
    cache evicts; both views close."""
    s = pkg.zensan.SAN
    shared = pkg.Shared(12, history=pkg.History())
    cache = shared.prefix_cache(
        ("flow",), lambda: pkg.Prefix(("flow",), shared._give))
    views = {}
    for app in ("a", "b"):
        v = shared.view(app, quota="fair", policy="fixed",
                        fixed_init_pages=1, fixed_step_pages=1)
        v.prefix_cache = cache
        cache.users.add(app)
        views[app] = v
    va, vb = views["a"], views["b"]

    def admit(v, rid, toks):
        r = pkg.Request(rid, len(toks), max_new_tokens=8,
                        prompt_tokens=toks)
        m = cache.pin(toks, max_len=len(toks) - 1)
        r.prefix_nodes, r.shared_pages = m.nodes, list(m.phys_pages)
        r.cached_len, r.cow_src_page = m.cached_len, m.cow_src
        assert v.try_admit(r)
        s.check(v)
        return r

    ra = admit(va, "a0", tuple(range(2 * PAGE_SIZE + 5)))
    phys = va.cache_donate(ra.pages[:2])            # the donation
    del ra.pages[:2]
    ra.shared_pages.extend(phys)
    ra.prefix_nodes = (ra.prefix_nodes or []) + cache.insert(
        ra.prompt_tokens[:2 * PAGE_SIZE], 0, phys)
    s.check(va)
    rb = admit(vb, "b0", tuple(range(PAGE_SIZE + 3)))
    assert rb.shared_pages                          # a prefix hit
    ra2 = admit(va, "a1", tuple(range(500, 500 + PAGE_SIZE)))
    va.release(ra2)                                 # a preemption
    s.check(va)
    g, l = va.reclaim(ra)                           # park
    va.parked = True
    s.check(va)
    va.parked = False                               # unpark
    m = cache.pin(ra.prompt_tokens, max_full=ra.parked_shared)
    ra.prefix_nodes, ra.shared_pages = m.nodes, list(m.phys_pages)
    ra.parked_shared = 0
    assert va.regrant(ra, len(g), len(l))
    s.unpark_done(va, "a")
    s.check(va)
    vb.release(rb)
    va.release(ra)
    s.check(vb)
    assert shared._evict_prefix(1) == 1             # an eviction
    s.check(va)
    for v in (va, vb):
        v.close()


def test_hook_log_model_free_flow_matches_reference():
    got = _logged(PORT, _model_free_flow)
    want = _logged(JAX, _model_free_flow)
    kinds = {e[0] for e in got}
    assert {"take", "give", "grant", "release", "cache_donated", "pinned",
            "unpinned", "inserted", "evicted", "parked", "regranted",
            "unpark_done", "view_closed", "check"} <= kinds
    assert got == want


def _cluster_flow(pkg):
    """Reduced tinyllama-1.1b, paged, with the prefix cache, beside a
    co-tenant of the same KV shape on one pod pool: a request warms the
    cache, a second one hits it and is parked mid-decode by ``park_app``
    and unparked by ``unpark_app``, both run to the end and are
    released."""
    cluster = pkg.Cluster(pods=1, history=pkg.History(),
                          executor=pkg.executor(), pool_pages=64)

    def submit(name):
        return cluster.submit(pkg.App.serve(
            "tinyllama-1.1b", reduced=True, name=name,
            serve=pkg.Opts(max_batch=2, backend="paged", policy="fixed",
                           cache_len=1024, prefix_cache=True)))

    h, keeper = submit("parker"), submit("keeper")
    shared = tuple((7919 + i * 31) % 211 for i in range(2 * PAGE_SIZE + 25))
    reqs = [pkg.Request(f"px{i}", len(shared) + 70, 3, prompt_tokens=shared
                        + tuple(((100 + i) * 7919 + j * 31) % 211
                                for j in range(70))) for i in range(2)]
    keeper.submit_request(pkg.Request("k0", 40, 3, prompt_tokens=tuple(
        range(40))))
    h.submit_request(reqs[0])
    while h.step()["alive"]:
        pass
    h.submit_request(reqs[1])
    h.step()
    keeper.step()
    h.park()
    h.unpark()
    while h.step()["alive"] | keeper.step()["alive"]:
        pass
    h.release()
    keeper.release()


def test_hook_log_cluster_flow_matches_reference():
    got = _logged(PORT, _cluster_flow)
    want = _logged(JAX, _cluster_flow)
    kinds = {e[0] for e in got}
    assert {"take", "grant", "release", "give", "cache_donated", "pinned",
            "unpinned", "inserted", "parked", "regranted", "unpark_done",
            "table", "view_closed", "check"} <= kinds
    assert got == want
