"""The port's pod-shared KV memory against the JAX package's, on CPU.

The non-park cases of the reference's ``tests/test_kv_alias.py``: the
view-local -> physical remap and its isolation guard, a quota shrink
moving physical pages to a co-tenant, ``reclaim`` returning physical ids
(each run through both packages' ``SharedPagePool``/``PoolView``, every
id EQUAL), and the mixed pod (two aliased tinyllama-1.1b tenants, one with
``alias_kv=False`` and a gemma3-12b tenant on its own store) through both
packages' ``Cluster``s on the reference's weights.  Then the router's
paged drain (token-identical migration onto a survivor's view of the one
store) and the dense requeue of ``tests/test_router.py``, and a
two-replica app holding one store's bytes.
"""

import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.history import HistoryStore as JaxHistory
from repro.models import ImplConfig, build_model
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import ServeOptions as JaxOpts
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import tenancy as jax_tenancy
from repro_torch.bridge import params_from_jax
from repro_torch.core.history import HistoryStore
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import kv_cache as torch_kv
from repro_torch.serving import tenancy as torch_tenancy

PAGE = torch_kv.PAGE_SIZE

JAX = types.SimpleNamespace(
    SharedPagePool=jax_tenancy.SharedPagePool, Request=jax_kv.Request,
    Engine=jax_engine.ServingEngine, Cluster=JaxCluster, App=JaxApp,
    Opts=JaxOpts, History=JaxHistory)
PORT = types.SimpleNamespace(
    SharedPagePool=torch_tenancy.SharedPagePool, Request=torch_kv.Request,
    Engine=torch_engine.ServingEngine, Cluster=Cluster, App=Application,
    Opts=ServeOptions, History=HistoryStore)


# ---------------------------------------------------------------------------
# the remap itself (no model)
# ---------------------------------------------------------------------------

def _remap_isolation(pkg):
    shared = pkg.SharedPagePool(8)
    a = shared.view("a", policy="fixed", fixed_init_pages=1)
    b = shared.view("b", policy="fixed", fixed_init_pages=1)
    ra = pkg.Request("ra", PAGE * 2 - 4, 4)          # 2 pages
    assert a.try_admit(ra)
    ids = list(ra.pages)
    phys = a.to_physical(ids)
    assert len(set(phys)) == 2 and set(phys).isdisjoint(shared.free)
    a.release(ra)
    with pytest.raises(KeyError, match="does not own"):
        a.to_physical(ids)
    rb = pkg.Request("rb", PAGE * 2 - 4, 4)
    assert b.try_admit(rb)
    got_b = b.to_physical(rb.pages)
    assert set(got_b) & set(phys), \
        "freed physical pages must be grantable to the co-tenant"
    rc = pkg.Request("rc", PAGE - 4, 4)
    assert a.try_admit(rc)
    assert set(rc.pages) <= set(ids), "freed view-local ids are recycled"
    return [ids, phys, list(rb.pages), got_b, list(rc.pages),
            a.to_physical(rc.pages), sorted(shared.free), a.used, b.used]


def _quota_shrink(pkg):
    shared = pkg.SharedPagePool(4)
    a = shared.view("a", policy="fixed", fixed_init_pages=1,
                    fixed_step_pages=1)
    b = shared.view("b", policy="fixed", fixed_init_pages=1,
                    fixed_step_pages=1)
    ea, eb = pkg.Engine(a, max_batch=4), pkg.Engine(b, max_batch=4)
    for i in range(2):                                # 2 pages each
        ea.submit(pkg.Request(f"a{i}", PAGE * 2 - 4, 8))
    ea.step()
    assert a.used == 4 and len(shared.free) == 0
    held = {r.req_id: (list(r.pages), a.to_physical(r.pages))
            for r in ea.running}
    preempted = a.resize_quota(2)
    assert preempted == 1 and a.used == 2
    victim = next(r for r in list(ea.queue) if r.state == "queued")
    old_ids, old_phys = held[victim.req_id]
    assert sorted(shared.free) == sorted(old_phys)
    with pytest.raises(KeyError, match="does not own"):
        a.to_physical(old_ids)
    eb.submit(pkg.Request("big", PAGE * 2 - 4, 8))
    eb.step()
    assert len(eb.running) == 1
    got = b.to_physical(eb.running[0].pages)
    assert set(got) == set(old_phys)
    assert a.used + b.used == shared.used_pages
    return [sorted(held.items()), victim.req_id, got, a.used, b.used,
            dict(shared.stats["preemptions"])]


def _reclaim_physical(pkg):
    shared = pkg.SharedPagePool(8)
    a = shared.view("a", policy="fixed", fixed_init_pages=1)
    r = pkg.Request("r", PAGE * 2 - 4, 4)
    assert a.try_admit(r)
    phys_before = a.to_physical(r.pages)
    g, l = a.reclaim(r)
    assert g == phys_before and l == []
    assert r.pages == [] and r.state == "parked"
    assert sorted(shared.free) == list(range(8))
    return [phys_before, g, l, a.used]


@pytest.mark.parametrize("case", [_remap_isolation, _quota_shrink,
                                  _reclaim_physical])
def test_pool_view_cases_match_reference(case):
    """Remap isolation, a quota shrink below usage, and ``reclaim``: the
    port's view-local and physical ids are the reference's."""
    assert case(PORT) == case(JAX)


# ---------------------------------------------------------------------------
# real paged runners aliasing one store
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def params():
    """The reference's reduced weights (its executors' init, seed 0)."""
    return {name: jax.tree.map(np.asarray, build_model(
        jax_reduced(jax_get_config(name)), ImplConfig(remat="none"))
        .init_params(jax.random.PRNGKey(0)))
        for name in ("tinyllama-1.1b", "gemma3-12b")}


def _cluster(pkg, params, pool_pages):
    ex = (JaxExecutor(seed=0) if pkg is JAX
          else BridgedExecutor(params, device="cpu"))
    return pkg.Cluster(pods=1, history=pkg.History(), executor=ex,
                       pool_pages=pool_pages)


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(int(t) for t in rng.integers(0, 256, n))


def _submit(pkg, h, reqs):
    out = []
    for rid, prompt, gen, seed in reqs:
        r = pkg.Request(rid, prompt, gen, prompt_tokens=_prompt(prompt, seed))
        h.submit_request(r)
        out.append(r)
    return out


def _drive(handles, max_steps=8000):
    alive = set(range(len(handles)))
    steps = 0
    while alive and steps < max_steps:
        for t in list(alive):
            if not handles[t].step()["alive"]:
                alive.discard(t)
        steps += 1
    assert not alive, "tenants did not drain"


def _stats(pkg, h):
    return h.serving_stats() if pkg is JAX else h.stats_view.cumulative()


def _mixed_pod(pkg, params):
    cluster = _cluster(pkg, params, 64)
    mk = lambda name, arch, **o: cluster.submit(pkg.App.serve(
        arch, reduced=True, name=name,
        serve=pkg.Opts(max_batch=4, backend="paged", policy="fixed", **o)))
    a = mk("alias-a", "tinyllama-1.1b")
    b = mk("alias-b", "tinyllama-1.1b")
    c = mk("private-c", "tinyllama-1.1b", alias_kv=False)
    d = mk("other-d", "gemma3-12b")
    shared = cluster.pod_pool("pod0")
    assert a.runner.store is b.runner.store, "same shape must alias"
    assert c.runner.store is not a.runner.store, "alias_kv=False is private"
    assert d.runner.store is not a.runner.store, "shape mismatch no alias"
    assert a.runner.shared_kv and b.runner.shared_kv
    assert not c.runner.shared_kv
    keys = sorted(map(str, shared.kv_stores))
    same = [("r0", 200, 6, 1), ("r1", 64, 6, 2)]
    ra, rb, rc = (_submit(pkg, h, same) for h in (a, b, c))
    rd = _submit(pkg, d, [("d0", 200, 8, 3), ("d1", 96, 8, 4)])
    _drive([a, b, c, d])
    toks = lambda rs: [tuple(r.output_tokens) for r in rs]
    assert toks(ra) == toks(rb) == toks(rc), \
        "aliased tenants must be token-exact vs private tensors"
    sa = _stats(pkg, a)
    assert sa["kv_aliased"] is True and sa["completed"] == 2
    assert sa["kv_device_bytes"] == _stats(pkg, b)["kv_device_bytes"]
    # pod-level live bytes count the aliased store ONCE
    assert (sa["shared_pool"]["kv_device_bytes"]
            == a.runner.store.device_bytes() + d.runner.store.device_bytes())
    out = [keys, toks(ra), toks(rd), sa["shared_pool"]["used_pages"],
           sa["shared_pool"]["num_pages"],
           sa["shared_pool"]["kv_device_bytes"] // a.runner.num_layers]
    for h in (a, b, c, d):
        h.release()
    assert not shared.kv_stores, "last tenant takes the store with it"
    return out


def test_mixed_pod_aliasing_matches_reference(params):
    """Two same-model tenants alias ONE store, a same-model tenant with
    ``alias_kv=False`` keeps private tensors, and gemma3-12b (another KV
    shape, with ring pages) falls back to its own store; tokens are
    exact across the three tinyllama tenants and equal the reference's,
    as are the store keys and the pod's page and byte accounting."""
    got = _mixed_pod(PORT, params)
    assert got == _mixed_pod(JAX, params)


# ---------------------------------------------------------------------------
# replica drain: token-identical migration, and the dense requeue
# ---------------------------------------------------------------------------

def _paged_tokens(pkg, params, replicas, drain_after=None):
    """The reference's case: 4 requests on the paged backend, max batch 2,
    a pool of 96; optionally one replica drained mid-decode."""
    cluster = _cluster(pkg, params, 96)
    h = cluster.submit(pkg.App.serve(
        "tinyllama-1.1b", reduced=True, name="drain",
        serve=pkg.Opts(backend="paged", max_batch=2, replicas=replicas,
                       pool_pages=96, cache_len=512)))
    reqs = _submit(pkg, h, [(f"r{i}", 40 + 7 * i, 8, 10 + i)
                            for i in range(4)])
    receipt = None
    if drain_after is not None:
        for _ in range(drain_after):
            h.step()
        receipt = h.remove_replica()
    h.run(max_steps=500)
    toks = {r.req_id: list(r.output_tokens) for r in reqs}
    h.release()
    return toks, receipt


def test_replica_drain_token_identical_migration(params):
    """Mid-decode scale-in migrates in-flight requests to a survivor with
    their KV and the continuation is token-identical: replicas decode
    through one set of page tensors.  Tokens and the receipt equal the
    reference's."""
    ref, _ = _paged_tokens(PORT, params, replicas=1)
    got, receipt = _paged_tokens(PORT, params, replicas=3, drain_after=3)
    want, want_receipt = _paged_tokens(JAX, params, replicas=3,
                                       drain_after=3)
    assert receipt["migrated_requests"] >= 1 and receipt == want_receipt
    assert receipt["requeued_requests"] == 0
    assert all(len(t) > 8 for t in got.values())
    assert got == ref == want


def _dense_drain(pkg, params):
    cluster = _cluster(pkg, params, 64)
    h = cluster.submit(pkg.App.serve(
        "tinyllama-1.1b", reduced=True, name="dense-drain",
        serve=pkg.Opts(backend="dense", max_batch=2, replicas=2)))
    reqs = _submit(pkg, h, [(f"d{i}", 16 + 5 * i, 4, 20 + i)
                            for i in range(3)])
    for _ in range(2):
        h.step()
    receipt = h.remove_replica()
    assert receipt["migrated_requests"] == 0
    assert receipt["requeued_requests"] >= 1
    h.run(max_steps=500)
    assert _stats(pkg, h)["completed"] == 3
    assert all(len(r.output_tokens) > 4 for r in reqs)
    out = [receipt, [list(r.output_tokens) for r in reqs]]
    h.release()
    return out


def test_dense_drain_falls_back_to_requeue(params):
    """The dense backend has no migratable page identity: scale-in
    requeues the victim's work at the router front and re-executes it,
    as the reference does, with the reference's tokens."""
    assert _dense_drain(PORT, params) == _dense_drain(JAX, params)


def test_replicas_hold_one_store_and_one_set_of_weights(params):
    """Two replicas of one paged app on the pod pool alias one store and
    one set of weights: the app's footprint on its device equals a
    one-replica app's, and the pod registers one store."""
    held = {}
    for n in (1, 2):
        cluster = _cluster(PORT, params, 48)
        h = cluster.submit(Application.serve(
            "tinyllama-1.1b", reduced=True, name=f"rep{n}",
            serve=ServeOptions(backend="paged", max_batch=2, replicas=n)))
        reps = h.replica_set.replicas
        assert len(reps) == n
        assert len({id(r.runner.store) for r in reps}) == 1
        assert len({id(r.runner.params["embed"]["tok"]) for r in reps}) == 1
        assert len(cluster.pod_pool("pod0").kv_stores) == 1
        store = reps[0].runner.store
        held[n] = (cluster.executor.footprint(h), store.device_bytes())
        h.release()
        assert store.device_bytes() == 0, "the last release drops it"
    assert held[2] == held[1]
