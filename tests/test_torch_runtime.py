"""The port's resource-centric runtime against the JAX package's, on CPU.

``ServeOptions``/``ScalePolicy`` validation, ``Application``, the
``Cluster``/``AppHandle`` lifecycle with the ``NullExecutor`` (the
reference's own cases of ``tests/test_runtime.py``, each run through both
packages and compared EXACTLY: demands, sizing solutions, capacity
snapshots), the router/replica data plane and its stats view, and the
``TorchExecutor`` on the CPU against the reference's ``JaxExecutor``:
reduced tinyllama-1.1b served through ``Cluster.submit`` with bridged
weights and explicit prompts gives EQUAL greedy tokens, a second
submission is sized from the first one's history exactly as the
reference sizes it, and reduced training gives losses within 1e-3
relative.  The options the port once refused (the pod-shared pool, KV
aliasing, the prefix cache) serve like the reference's, and its control
plane (``enable_autoscale``, ``tick``, parking) works like the
reference's; what it still does not bring (plans on more than one card)
raises ``NotImplementedError`` naming its queue item.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.history import HistoryStore as JaxHistory
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import NullExecutor as JaxNull
from repro.runtime import ScalePolicy as JaxScale
from repro.runtime import ServeOptions as JaxOpts
from repro.serving.kv_cache import Request as JaxRequest
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.core.annotations import AppLimits
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import H100, MeshSpec
from repro_torch.core.scheduler import PodState
from repro_torch.runtime import (Application, Cluster, NullExecutor,
                                 ScalePolicy, ServeOptions, TorchExecutor)
from repro_torch.serving.kv_cache import PAGE_SIZE, Request
from repro_torch.training import optimizer as topt

GB = 1 << 30


# ---------------------------------------------------------------------------
# ServeOptions / ScalePolicy (the JAX-free cases of test_serve_options.py)
# ---------------------------------------------------------------------------

def test_options_defaults_match_reference():
    assert dataclasses.asdict(ServeOptions()) == dataclasses.asdict(JaxOpts())
    assert dataclasses.asdict(ScalePolicy()) == dataclasses.asdict(JaxScale())


@pytest.mark.parametrize("kw,match", [
    ({"backend": "sparse"}, "backend"),
    ({"prefix_cache": True}, "backend"),          # dense + prefix cache
    ({"replicas": 0}, "replicas"),
    ({"replicas": 2, "private_pool": True}, "private_pool"),
    ({"max_batch": 0}, "max_batch"),
    ({"policy": "generous"}, "policy"),
    ({"weight": 0.0}, "weight"),
    ({"replicas": 4, "scale": "max2"}, "max_replicas"),
])
def test_serve_options_reject_what_the_reference_rejects(kw, match):
    def build(opts_cls, scale_cls):
        k = dict(kw)
        if k.get("scale") == "max2":
            k["scale"] = scale_cls(max_replicas=2)
        return opts_cls(**k)
    with pytest.raises(ValueError, match=match):
        build(JaxOpts, JaxScale)
    with pytest.raises(ValueError, match=match):
        build(ServeOptions, ScalePolicy)


@pytest.mark.parametrize("kw,match", [
    ({"min_replicas": -1}, "min_replicas"),
    ({"min_replicas": 3, "max_replicas": 2}, "max_replicas"),
    ({"batch_min": 0}, "batch_min"),
    ({"batch_min": 4, "batch_max": 2}, "batch_max"),
    ({"shrink_occupancy": 0.9, "grow_occupancy": 0.5}, "occupancy"),
    ({"unpark_lead_s": -1.0}, "unpark_lead_s"),
])
def test_scale_policy_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxScale(**kw)
    with pytest.raises(ValueError, match=match):
        ScalePolicy(**kw)


def test_options_flags_kwargs_and_mirror():
    """The scaling flags; options are frozen; ``Application.serve`` takes
    its options as ``serve=ServeOptions(...)`` and nothing else (the
    reference's deprecated keyword path is not ported)."""
    assert ScalePolicy(max_replicas=3).scales_replicas
    assert ScalePolicy(min_replicas=0).scales_replicas
    assert not ScalePolicy().scales_batch and ScalePolicy(
        batch_max=8).scales_batch
    with pytest.raises(AttributeError):
        ServeOptions(max_batch=4).max_batch = 8
    with pytest.raises(TypeError, match="max_batch"):
        Application.serve("tinyllama-1.1b", reduced=True, max_batch=4)
    typed = Application.serve("tinyllama-1.1b", reduced=True,
                              serve=ServeOptions(max_batch=4,
                                                 backend="paged"))
    assert typed.serve_options == ServeOptions(max_batch=4, backend="paged")
    assert Application.serve("tinyllama-1.1b").serve_options == \
        ServeOptions()


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "rwkv6-7b"])
def test_application_demand_matches_reference(arch):
    for reduced in (False, True):
        for kind in ("train", "serve"):
            t = getattr(Application, kind)(arch, reduced=reduced)
            j = getattr(JaxApp, kind)(arch, reduced=reduced)
            assert (t.name, t.shape.name, t.estimate_demand(),
                    t.structural_floor()) == (j.name, j.shape.name,
                                              j.estimate_demand(),
                                              j.structural_floor())
            t.limits = AppLimits(max_hbm_bytes=GB)
            assert t.capped_demand(t.estimate_demand()) == min(
                GB, j.estimate_demand())


def test_application_from_callable_carries_annotations():
    from repro_torch.configs import get_config
    from repro_torch.core import annotations as ann

    @ann.app_limit(max_chips=1)
    @ann.compute(parallelism="token", name="user_app")
    def my_app():
        return get_config("tinyllama-1.1b")

    app = Application.from_callable(my_app, kind="train")
    assert app.name == "user_app" and app.limits.max_chips == 1
    assert app.resource_graph().total_flops() > 0
    assert any(c["name"] == "user_app"
               for c in ann.collected_annotations())
    syn = Application.synthetic("s", "serve", 3 * GB)
    assert syn.resource_graph() is None and syn.estimate_demand() == 3 * GB


# ---------------------------------------------------------------------------
# Cluster lifecycle with the NullExecutor, each case in both packages
# ---------------------------------------------------------------------------

def _both(fn):
    """Run ``fn(pkg)`` with the reference's and the port's runtime; the
    results must be equal."""
    import repro.core.scheduler as jsched
    jax_pkg = dict(Cluster=JaxCluster, App=JaxApp, Null=JaxNull,
                   Hist=JaxHistory, Pod=jsched.PodState)
    port = dict(Cluster=Cluster, App=Application, Null=NullExecutor,
                Hist=HistoryStore, Pod=PodState)
    want, got = fn(jax_pkg), fn(port)
    assert got == want
    return got


def _pending_drains(p):
    c = p["Cluster"]([p["Pod"]("p", 4, 16 * GB)], executor=p["Null"]())
    a = c.submit(p["App"].synthetic("a", "train", 60 * GB))
    b = c.submit(p["App"].synthetic("b", "train", 60 * GB))
    out = [a.state, b.state, c.capacity()]
    a.release()
    out += [b.state, c.capacity(), len(c.running), len(c.pending)]
    b.release()
    d = c.submit(p["App"].synthetic("d", "train", 100 * GB))
    out += [d.state, len(c.pending)]
    d.release()
    out += [c.capacity(), len(c.scheduler.pending)]
    return out


def _history_sizing(p):
    hist = p["Hist"]()
    for _ in range(30):
        hist.observe("syn", "job", "bytes", 8 * GB)
    c = p["Cluster"](pods=1, history=hist, executor=p["Null"]())
    demand, sol = c.size(p["App"].synthetic("syn", "serve", 2 * GB))
    hist2 = p["Hist"]()
    hist2.observe("tinyllama-1.1b:train", "job", "bytes", 1.0)
    c2 = p["Cluster"](pods=1, history=hist2, executor=p["Null"]())
    app = p["App"].train("tinyllama-1.1b")
    floor_demand, floor_sol = c2.size(app)
    assert floor_demand >= app.structural_floor() > 0
    return demand, dataclasses.astuple(sol), floor_demand, \
        dataclasses.astuple(floor_sol)


def _app_limit_and_reservations(p):
    hist = p["Hist"]()
    hist.observe("greedy", "job", "bytes", 70 * GB)
    c = p["Cluster"]([p["Pod"]("a", 1, 80 * GB), p["Pod"]("b", 1, 80 * GB)],
                     history=hist, executor=p["Null"]())
    capped = p["App"].synthetic("capped", "train", 100 * GB)
    capped.limits = type(capped.limits)(max_hbm_bytes=10 * GB)
    h1 = c.submit(capped)
    g = c.submit(p["App"].synthetic("greedy", "train", 10 * GB))
    o = c.submit(p["App"].synthetic("other", "train", 50 * GB))
    out = [h1.job.demand_bytes, g.pod, o.pod, c.capacity(),
           dict(c.scheduler.reservations)]
    out += [g.scale_up(5 * GB), g.scale_down(2 * GB), c.capacity(),
            dict(c.scheduler.reservations)]
    for h in (h1, g, o):
        h.release()
    out += [c.capacity(), hist.get("greedy", "job", "bytes").to_json()]
    return out


@pytest.mark.parametrize("case", [_pending_drains, _history_sizing,
                                  _app_limit_and_reservations])
def test_cluster_null_executor_matches_reference(case):
    _both(case)


def test_escalate_moves_the_plan_up_the_ladder():
    def case(p):
        c = p["Cluster"](pods=1, executor=p["Null"]())
        h = c.submit(p["App"].train("tinyllama-1.1b"))
        plans = [h.plan.describe()]
        while h.escalate(measured_bytes=1 << 60):
            plans.append(h.plan.describe())
        h.release()
        return plans, c.capacity()
    from repro.core.materializer import MeshSpec as JaxMesh
    from repro_torch.core.materializer import H100
    # the reference on the port's one-card mesh
    jmesh = JaxMesh("h100", (1, 1), ("data", "model"),
                    hbm_per_device=H100.hbm_per_device,
                    peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw,
                    ici_bw=H100.ici_bw)
    want = case(dict(Cluster=lambda **kw: JaxCluster(mesh=jmesh, **kw),
                     App=JaxApp, Null=JaxNull))
    got = case(dict(Cluster=Cluster, App=Application, Null=NullExecutor))
    assert got == want and len(got[0]) > 1


# ---------------------------------------------------------------------------
# the serving data plane with the NullExecutor: router, replicas, stats
# ---------------------------------------------------------------------------

def _untimed(d):
    """A stats dict without its wall-clock values."""
    if isinstance(d, list):
        return [_untimed(x) for x in d]
    if not isinstance(d, dict):
        return d
    return {k: _untimed(v) for k, v in d.items()
            if not (k.endswith("_s") or k.endswith("_s_sum"))}


def _serve_null(p, opts_cls):
    c = p["Cluster"]([p["Pod"]("pod0", 1, 80 * GB)], history=p["Hist"](),
                     executor=p["Null"]())
    h = c.submit(p["App"].serve(
        "tinyllama-1.1b", reduced=True, name="svc",
        serve=opts_cls(max_batch=2, pool_pages=16, policy="fixed",
                       private_pool=True)))
    req = JaxRequest if p["App"] is JaxApp else Request
    for i in range(7):
        h.submit_request(req(f"r{i}", PAGE_SIZE - 4 + 9 * i, 6 + i))
    marker = h.stats_view.cumulative()
    h.add_replica()
    for _ in range(3):
        h.step()
    receipt = h.remove_replica()
    h.run(max_steps=1000)
    out = [receipt, _untimed(h.stats_view.cumulative()),
           _untimed(h.stats_view.windowed(marker))]
    h.release()
    out.append(c.capacity())
    return out


def test_router_replicas_and_stats_match_reference():
    """Seven requests on a private-pool app, a second replica added after
    the first window, three steps, the replica removed again (its running
    requests regranted on the survivor), drained: the removal receipt,
    the cumulative and windowed stats (times left out) and the capacity
    equal the reference's."""
    got = _both(lambda p: _serve_null(
        p, JaxOpts if p["App"] is JaxApp else ServeOptions))
    cum = got[1]
    assert cum["completed"] == 7 and cum["router"]["dispatched"] >= 7
    assert cum["replicas"][0]["view"] == "svc" and not cum["windowed"]


# ---------------------------------------------------------------------------
# the TorchExecutor on the CPU against the JaxExecutor
# ---------------------------------------------------------------------------

class BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights."""

    def __init__(self, jax_params, **kw):
        super().__init__(**kw)
        self.jax_params = jax_params

    def init_params(self, handle):
        return params_from_jax(self.jax_params, handle.app.config,
                               self.device)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _serve_rounds(cluster, app_of, req_cls, prompts, rounds=2, first=0):
    """Submit, serve the prompts, release; ``rounds`` times under one app
    name.  Returns each round's tokens, sizing, grant and pool grants, and
    the last runner."""
    out = []
    for rnd in range(first, first + rounds):
        h = cluster.submit(app_of())
        pool = h.engine.pool
        reqs = [req_cls(f"q{rnd}.{i}", len(p), 6, prompt_tokens=p)
                for i, p in enumerate(prompts)]
        for r in reqs:
            h.submit_request(r)
        h.run(max_steps=500)
        sz = pool.sizing()
        out.append(([r.output_tokens for r in reqs],
                    None if h.sizing is None
                    else dataclasses.astuple(h.sizing),
                    h.job.demand_bytes, (sz.init, sz.step),
                    {k: pool.stats[k] for k in ("grants", "grant_pages",
                                                "scaleups", "denials")}))
        runner = h.runner
        h.release()
    return out, runner


def test_cluster_serving_matches_reference_and_sizes_from_history(tmp_path):
    """Reduced tinyllama-1.1b, paged backend on private pools, policy
    "history": prompts of 200 and 700 tokens (native and chunked
    prefill), 6 new tokens, two submissions of one app on one cluster.
    Tokens and the pools' history-solved grants are EXACTLY the
    reference's.  The job level records what the app held on its device
    (weights and KV pages: the port's grant grows to it, where the
    reference records its estimate), and the second submission's
    SizingSolution and demand are EXACTLY what the reference's Cluster
    solves over that same history."""
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, 256, n))
               for n in (200, 700, 90)]
    opts = dict(backend="paged", max_batch=4, pool_pages=32,
                private_pool=True)
    jh = JaxHistory()
    want, jrunner = _serve_rounds(
        JaxCluster(pods=1, history=jh, executor=JaxExecutor()),
        lambda: JaxApp.serve("tinyllama-1.1b", reduced=True,
                             serve=JaxOpts(**opts)),
        JaxRequest, prompts)
    th = HistoryStore(str(tmp_path))
    ex = BridgedExecutor(_np_tree(jrunner.params), device="cpu")
    cluster = Cluster(history=th, executor=ex)

    def app():
        return Application.serve("tinyllama-1.1b", reduced=True,
                                 serve=ServeOptions(**opts))

    got, _ = _serve_rounds(cluster, app, Request, prompts, rounds=1)
    th.save()
    jsol = JaxCluster(pods=1, history=JaxHistory(str(tmp_path)),
                      executor=JaxNull()).size(
        JaxApp.serve("tinyllama-1.1b", reduced=True, serve=JaxOpts(**opts)))
    more, runner = _serve_rounds(cluster, app, Request, prompts, rounds=1,
                                 first=1)
    got += more
    assert runner.device == torch.device("cpu")
    assert [(g[0], g[3], g[4]) for g in got] == [
        (w[0], w[3], w[4]) for w in want]
    (first, second) = got
    assert first[1] is None and second[1] == dataclasses.astuple(jsol[1])
    assert second[3] != first[3]                         # pool grants too
    held = (sum(t.numel() * t.element_size()
                for t in jax.tree.leaves(runner.params))
            + runner.store.device_bytes())
    job = th.get("tinyllama-1.1b:serve", "job", "bytes")
    assert job.count == 2 and first[2] >= held and second[2] >= held
    assert job.last == second[2] and held > want[0][2]
    quantum = 64 << 20
    assert second[2] == max(jsol[0], -(-held // quantum) * quantum)
    key = ("tinyllama-1.1b:serve", "request", "pages")
    assert th.get(*key).to_json() == jh.get(*key).to_json()


def test_cluster_training_matches_reference():
    """Reduced tinyllama-1.1b training through ``Cluster.submit``: the
    ladder's plan equals the reference's, and three steps from the
    reference's weights on the same batches give losses within 1e-3
    relative of its jitted steps."""
    ocfg = dict(warmup_steps=1, peak_lr=1e-3)
    jc = JaxCluster(pods=1, executor=JaxExecutor(
        opt_cfg=jopt.OptimizerConfig(**ocfg)))
    jhandle = jc.submit(JaxApp.train("tinyllama-1.1b", reduced=True))
    jparams = _np_tree(jhandle.exec_state["params"])
    jhandle.run(steps=3)
    tc = Cluster(pods=1, executor=BridgedExecutor(
        jparams, device="cpu", opt_cfg=topt.OptimizerConfig(**ocfg)))
    thandle = tc.submit(Application.train("tinyllama-1.1b", reduced=True))
    out = thandle.run(steps=3)
    assert out["steps"] == 3 and out["straggled"] == 0
    for tm, jm in zip(thandle.metrics, jhandle.metrics):
        assert abs(tm["loss"] - jm["loss"]) <= 1e-3 * abs(jm["loss"])
    assert thandle.plan.remat == jhandle.plan.remat == "none"
    assert thandle.plan.microbatch == jhandle.plan.microbatch == 1
    cap0 = tc.capacity()
    assert thandle.scale_up(2 * GB) and thandle.scale_down(GB) == GB
    thandle.release()
    jhandle.release()
    assert tc.capacity() != cap0 and tc.capacity()["pod0"]["running"] == 0


def test_train_step_is_cached_by_plan_layout():
    from repro_torch.core.compile_cache import CompileCache
    cache = CompileCache()
    c = Cluster(pods=1, executor=TorchExecutor(device="cpu",
                                               compile_cache=cache))
    for _ in range(2):
        h = c.submit(Application.train("tinyllama-1.1b", reduced=True))
        h.run(steps=1)
        h.release()
    assert cache.stats == {"hits": 1, "misses": 1, "prewarmed": 0,
                           "prewarm_hits": 0}


def test_training_grant_grows_to_what_the_app_holds():
    """A training app placed at a small explicit demand: binding grows its
    grant (in 64 MiB quanta) to its weights and AdamW state, and the
    finished job's history records that, so the next submission is
    sized from it."""
    hist = HistoryStore()
    c = Cluster(history=hist, executor=TorchExecutor(device="cpu"))
    app = Application.train("tinyllama-1.1b", reduced=True)
    app.demand_bytes = 1
    h = c.submit(app)
    st = h.exec_state
    held = sum(t.numel() * t.element_size() for t in
               jax.tree.leaves((st["params"], st["opt_state"]))
               if isinstance(t, torch.Tensor))
    quantum = 64 << 20
    assert h.job.demand_bytes == 1 + -(-(held - 1) // quantum) * quantum
    h.run(steps=1)
    grant = h.job.demand_bytes
    assert c.capacity()["pod0"]["free_bytes"] == H100.hbm_per_device - grant
    h.release()
    assert hist.get(app.name, "job", "bytes").last == grant >= held
    demand, sol = c.size(app)
    assert sol is not None and demand >= app.structural_floor()


def test_training_app_is_placed_at_the_plan_it_runs():
    """``train``'s application for full-width tinyllama-1.1b at train_4k
    (batch 256) is placed on one card at the estimate of the plan it runs
    -- the one-card default (full remat, 128 microbatches of 2) or given
    overrides -- where the profile's estimate for the whole batch without
    remat leaves it pending."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.train import one_card_overrides, training_app
    sh = SHAPES["train_4k"]
    assert one_card_overrides(sh) == {"remat": "full", "microbatch": 128}
    for ov in (None, {"remat": "full", "microbatch": 64}):
        c = Cluster(mesh=H100, executor=NullExecutor())
        app, used = training_app("tinyllama-1.1b", sh, overrides=ov)
        h = c.submit(app, overrides=used)
        assert h.state == "running" and used == (ov or one_card_overrides(sh))
        assert (h.plan.remat, h.plan.microbatch) == ("full",
                                                     used["microbatch"])
        assert h.job.demand_bytes == h.plan.est_bytes_per_device
        h.release()
    c = Cluster(mesh=H100, executor=NullExecutor())
    assert c.submit(Application.train("tinyllama-1.1b", shape=sh),
                    overrides=one_card_overrides(sh)).state == "pending"
    app, used = training_app("tinyllama-1.1b", sh, reduced=True)
    assert used is None and app.shape.name == "reduced_train"


def test_cluster_is_one_card_with_the_torch_executor():
    """One pod by default; a TorchExecutor binds every app on its one
    card, so a cluster of more pods is refused."""
    assert list(Cluster().capacity()) == ["pod0"]
    assert len(Cluster(pods=2, executor=NullExecutor()).capacity()) == 2
    for pods in (2, [PodState(f"p{i}", 1, 80 * GB) for i in range(3)]):
        with pytest.raises(NotImplementedError, match="multi-card"):
            Cluster(pods=pods, executor=TorchExecutor(device="cpu"))


# ---------------------------------------------------------------------------
# the options the port once refused serve now; what it still refuses names
# the queue item that brings it
# ---------------------------------------------------------------------------

_SERVED_ONCE_REFUSED = [
    ({"backend": "paged"}, "A6"),                       # pod-shared pool
    ({"backend": "paged", "alias_kv": True}, "alias_kv"),
    ({"backend": "paged", "private_pool": True, "prefix_cache": True},
     "A3"),
]


def _serve_both(kw, executor):
    """Reduced tinyllama-1.1b served with options ``kw`` through the
    reference's Cluster and the port's, three explicit prompts (the last
    two sharing the first's leading 160 tokens), one after another.
    ``executor`` "null": the NullExecutor in both (admission and paging
    only); "torch": the JaxExecutor, and the TorchExecutor on the CPU with
    the reference's weights.  Returns (reference, port), each (tokens,
    untimed stats, apps running after the release); the two meshes
    differ, so byte capacities are not compared."""
    rng = np.random.default_rng(3)
    base = [int(t) for t in rng.integers(0, 256, 160)]
    prompts = [tuple(base + [int(t) for t in rng.integers(0, 256, n)])
               for n in (40, 90, 200)]
    out, jparams = [], None
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            ex = JaxNull() if executor == "null" else JaxExecutor(seed=0)
            c = JaxCluster(pods=1, history=JaxHistory(), executor=ex,
                           pool_pages=48)
            app, opts, req = JaxApp, JaxOpts, JaxRequest
        else:
            ex = NullExecutor() if executor == "null" else BridgedExecutor(
                jparams, device="cpu")
            c = Cluster(pods=1, history=HistoryStore(), executor=ex,
                        pool_pages=48)
            app, opts, req = Application, ServeOptions, Request
        h = c.submit(app.serve("tinyllama-1.1b", reduced=True, name="svc",
                               serve=opts(max_batch=2, policy="fixed",
                                          **kw)))
        if jparams is None and executor == "torch":
            jparams = _np_tree(h.runner.params)
        reqs = [req(f"p{i}", len(p), 5, prompt_tokens=p)
                for i, p in enumerate(prompts)]
        for r in reqs:
            h.submit_request(r)
            h.run(max_steps=500)
        stats = _untimed(h.stats_view.cumulative())
        for k in ("kv_store_key", "kv_device_bytes", "shared_pool"):
            stats.pop(k, None)      # device bytes: jax vs torch layouts
        h.release()
        out.append(([r.output_tokens for r in reqs], stats,
                    c.capacity()["pod0"]["running"]))
    return out


@pytest.mark.parametrize("executor", ["null", "torch"])
@pytest.mark.parametrize("kw,item", _SERVED_ONCE_REFUSED)
def test_serve_refusals_name_their_queue_item(executor, kw, item):
    """Each of these options was refused until its queue item came (the
    pod-shared pool and KV aliasing with A6, the prefix cache with A3):
    each now serves, with the same tokens, stats and capacity as the
    reference."""
    want, got = _serve_both(kw, executor)
    assert got == want
    toks, stats, running = got
    assert stats["completed"] == 3 and running == 0
    if executor == "torch":
        assert all(len(t) == 6 for t in toks)
        assert stats["kv_aliased"] is (not kw.get("private_pool", False))
        if kw.get("prefix_cache"):
            assert stats["prefix_hit_rate"] == pytest.approx(2 / 3)


def test_control_plane_refusals_name_their_queue_item():
    """The control plane the port once refused (the autoscale controller
    and parking, queue item A6) now works as the reference's: the pod's
    shared pool (sized by the cluster's ``pool_pages``), ``tick`` before
    and after ``enable_autoscale``, and a park/unpark of a private-pool
    app mid-decode give the same pools, receipts (without ``parked_s``),
    capacities and stats as the reference's."""
    import repro.core.scheduler as jsched

    def run(cluster_cls, pod_cls, app_cls, opts_cls, null, req_cls):
        c = cluster_cls([pod_cls("pod0", 1, 80 * GB)], executor=null(),
                        pool_pages=40)
        pool = c.pod_pool("pod0")
        assert pool is c.pod_pool("pod0")
        out = [(pool.num_pages, pool.used_pages, pool.views), c.tick()]
        ctl = c.enable_autoscale(idle_park_s=2.0)
        assert c.autoscaler is ctl
        h = c.submit(app_cls.serve(
            "tinyllama-1.1b", reduced=True,
            serve=opts_cls(private_pool=True, max_batch=2)))
        h.submit_request(req_cls("r0", PAGE_SIZE + 9, 12))
        h.step()
        h.step()
        park = h.park()
        out += [h.parked, h.num_replicas, c.capacity(), park]
        unpark = h.unpark()
        unpark.pop("parked_s")
        out += [h.parked, unpark, c.capacity(), c.tick(now=0.0)]
        h.run(max_steps=500)
        out.append(_untimed(h.stats_view.cumulative()))
        h.release()
        return out + [c.capacity(), c.tick(now=1.0)]

    want = run(JaxCluster, jsched.PodState, JaxApp, JaxOpts, JaxNull,
               JaxRequest)
    got = run(Cluster, PodState, Application, ServeOptions, NullExecutor,
              Request)
    assert got == want
    assert got[:4] == [(40, 0, {}), [], True, 0]
    assert got[5]["drained_requests"] == 1
    assert got[7]["restored_requests"] == 1


def test_torch_executor_binds_one_card_only(monkeypatch):
    mesh = MeshSpec("dgx8", (2, 4), ("data", "model"))
    c = Cluster(pods=1, mesh=mesh, executor=TorchExecutor(device="cpu"))
    with pytest.raises(NotImplementedError, match="multi-card"):
        c.submit(Application.train("tinyllama-1.1b", reduced=True))
    assert c.capacity()["pod0"]["free_bytes"] == 8 * mesh.hbm_per_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExecutor()


def test_serve_binds_the_executor_it_is_given():
    """``launch.serve(executor=)`` binds through that executor: one whose
    ``init_params`` returns weights already made serves them, with the
    same traffic and tokens as a serve that makes them from the seed."""
    from repro_torch.launch.serve import serve
    kw = dict(reduced=True, device="cpu", requests=2, max_batch=2,
              prompt_range=(20, 140), max_new=3, verbose=False)
    first = serve(**kw)
    held, calls = first["runner"].params, []

    class Held(TorchExecutor):
        def init_params(self, handle):
            calls.append(handle.app.name)
            return held

    again = serve(**kw, executor=Held(device="cpu"))
    assert calls and again["runner"].params is held
    assert ([(r.prompt_len, r.output_tokens) for r in again["requests"]]
            == [(r.prompt_len, r.output_tokens) for r in first["requests"]])
