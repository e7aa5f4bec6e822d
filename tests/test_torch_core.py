"""The port's control-plane core against the JAX package's, on CPU.

History (``core/history.py``), profiles and the resource graph
(``core/profiles.py``, ``core/graph.py``), the locality ladder and
compile-feedback escalation (``core/materializer.py``), the plan-layout
key (``core/compile_cache.py``), the two-level scheduler
(``core/scheduler.py``) and the recovery helpers
(``checkpoint/recovery.py``): the same inputs go through both packages
and every result must be EXACTLY equal (these are host arithmetic over
the same analytic profiles; no tolerance).  The ladder is held on the
port's one-card mesh and on multi-device meshes built here, with the
same device figures in both packages.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.checkpoint import recovery as jrec
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core import compile_cache as jcc
from repro.core import graph as jgraph
from repro.core import history as jhist
from repro.core import materializer as jmat
from repro.core import profiles as jprof
from repro.core import scheduler as jsched
from repro.core.sizing import solve_init_step as jax_solve
from repro_torch.checkpoint import recovery as trec
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core import compile_cache as tcc
from repro_torch.core import graph as tgraph
from repro_torch.core import history as thist
from repro_torch.core import materializer as tmat
from repro_torch.core import profiles as tprof
from repro_torch.core import scheduler as tsched
from repro_torch.core.sizing import solve_init_step
from repro_torch.runtime.application import REDUCED_SHAPES

ARCHS = ("tinyllama-1.1b", "zamba2-2.7b", "rwkv6-7b")
GB = 1 << 30


def _cfgs(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    return (jax_reduced(j), reduced_config(t)) if reduced else (j, t)


def _jshape(sh):
    return JaxShape(sh.name, sh.kind, sh.seq_len, sh.global_batch)


#: every invocation class the tests hold: the named shapes, the reduced
#: ones, and the cut shapes the port runs on the card
ALL_SHAPES = (list(SHAPES.values()) + list(REDUCED_SHAPES.values()) + [
    ShapeConfig("train_4k_b8", "train", 4096, 8),
    ShapeConfig("decode_2048x8", "decode", 2048, 8),
    ShapeConfig("prefill_1k", "prefill", 1024, 3),
])


def _mesh_pair(name, shape, axes):
    """The same mesh in both packages (the port's device figures)."""
    t = tmat.MeshSpec(name, shape, axes)
    j = jmat.MeshSpec(name, shape, axes, hbm_per_device=t.hbm_per_device,
                      peak_flops=t.peak_flops, hbm_bw=t.hbm_bw,
                      ici_bw=t.ici_bw)
    return j, t


MESHES = [
    _mesh_pair("h100", (1, 1), ("data", "model")),
    _mesh_pair("dgx8", (2, 4), ("data", "model")),
    _mesh_pair("pods2x4x4", (2, 4, 4), ("pod", "data", "model")),
    _mesh_pair("pod16x16", (16, 16), ("data", "model")),
]


# ---------------------------------------------------------------------------
# history
# ---------------------------------------------------------------------------

def _observe(hist_cls, values, decay):
    h = hist_cls(decay=decay)
    for v in values:
        h.observe(float(v))
    return h


@pytest.mark.parametrize("decay", [0.98, 0.5])
def test_history_quantiles_decay_and_solve_match_reference(decay):
    rng = np.random.default_rng(3)
    values = np.concatenate([rng.integers(1, 40, 50),
                             rng.integers(200, 5000, 10), [1e9, 0.5]])
    j = _observe(jhist.DecayedHistogram, values, decay)
    t = _observe(thist.DecayedHistogram, values, decay)
    assert t.to_json() == j.to_json()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert (t.mean(), t.peak(), t.samples()) == (j.mean(), j.peak(),
                                                 j.samples())
    for quantum in (1.0, 64.0):
        assert dataclasses.astuple(solve_init_step(
            t.samples(), quantum=quantum)) == dataclasses.astuple(
                jax_solve(j.samples(), quantum=quantum))


def test_history_store_round_trips_between_packages(tmp_path):
    """The two stores write the same JSON: the port reads what the
    reference saved, and the reverse."""
    jst = jhist.HistoryStore(str(tmp_path / "j"))
    tst = thist.HistoryStore(str(tmp_path / "t"))
    for i in range(30):
        for st in (jst, tst):
            st.observe("app:serve", "request", "pages", 1 + i % 7)
            st.observe("app:serve", "job", "bytes", (i + 1) * GB)
    jst.save()
    tst.save()
    assert (tmp_path / "j" / "history.json").read_text() == \
        (tmp_path / "t" / "history.json").read_text()
    back = thist.HistoryStore(str(tmp_path / "j"))
    for key in (("app:serve", "request", "pages"),
                ("app:serve", "job", "bytes")):
        assert back.get(*key).to_json() == jst.get(*key).to_json()
        assert back.peak(*key) == jst.peak(*key)
    assert back.quantile("missing", "x", "y", 0.5, default=7.0) == 7.0


# ---------------------------------------------------------------------------
# profiles and the resource graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_profiles_match_reference(arch, reduced):
    jcfg, tcfg = _cfgs(arch, reduced)
    assert tprof.model_param_count(tcfg) == jprof.model_param_count(jcfg)
    assert tprof.model_active_param_count(tcfg) == \
        jprof.model_active_param_count(jcfg)
    assert tprof.param_bytes(tcfg) == jprof.param_bytes(jcfg)
    assert tprof.optimizer_bytes(tcfg) == jprof.optimizer_bytes(jcfg)
    for sh in ALL_SHAPES:
        jsh = _jshape(sh)
        assert tprof.kv_cache_bytes(tcfg, sh) == \
            jprof.kv_cache_bytes(jcfg, jsh)
        for remat in ("none", "dots", "full"):
            for mb in (1, 2):
                for impl in ("naive", "chunked"):
                    assert tprof.activation_bytes_train(
                        tcfg, sh, remat, mb, impl) == \
                        jprof.activation_bytes_train(jcfg, jsh, remat, mb,
                                                     impl)
        assert dataclasses.asdict(tprof.step_profile(tcfg, sh)) == \
            dataclasses.asdict(jprof.step_profile(jcfg, jsh))


def test_padded_num_experts_matches_reference():
    from repro.models.moe import padded_num_experts
    for n in (1, 8, 15, 16, 17, 60, 64):
        for m in (1, 16):
            assert tprof.padded_num_experts(n, m) == padded_num_experts(n, m)


def _graph_tuple(g):
    return ({n: dataclasses.asdict(c) for n, c in g.compute.items()},
            {n: dataclasses.asdict(d) for n, d in g.data.items()},
            [dataclasses.asdict(e) for e in g.edges],
            g.total_flops(), g.total_bytes(), g.shared_data(),
            g.cut_boundaries(), g.topo_order())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_resource_graph_matches_reference(arch, reduced):
    jcfg, tcfg = _cfgs(arch, reduced)
    for sh in ALL_SHAPES:
        assert _graph_tuple(tgraph.build_resource_graph(tcfg, sh)) == \
            _graph_tuple(jgraph.build_resource_graph(jcfg, _jshape(sh)))


# ---------------------------------------------------------------------------
# the locality ladder and escalation
# ---------------------------------------------------------------------------

def test_h100_mesh_carries_the_cards_figures():
    m = tmat.H100
    assert (m.shape, m.axes, m.num_devices) == ((1, 1), ("data", "model"), 1)
    assert (m.hbm_per_device, m.peak_flops, m.hbm_bw, m.ici_bw) == \
        (80_000_000_000, 989e12, 3.35e12, 900e9)
    assert tmat.MESHES == {"h100": m}


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ladder_matches_reference(arch, reduced, mesh_i):
    """``materialize`` gives the same plan (``describe()``, notes and
    ``est_bytes_per_device`` included) for every shape, with and without
    a history carrying a measured peak and with overrides; so does
    ``estimate_bytes_per_device`` of that plan."""
    jcfg, tcfg = _cfgs(arch, reduced)
    jmesh, tmesh = MESHES[mesh_i]
    for sh in ALL_SHAPES:
        jsh = _jshape(sh)
        jh, th = jhist.HistoryStore(), thist.HistoryStore()
        for h in (jh, th):
            h.observe(tcfg.name, f"{sh.name}/{tmesh.name}",
                      "bytes_per_device", 3 * GB)
        for kw_j, kw_t in (({}, {}),
                           ({"history": jh}, {"history": th}),
                           ({"overrides": {"remat": "full",
                                           "microbatch": 4}},) * 2):
            jp = jmat.materialize(jcfg, jsh, jmesh, **kw_j)
            tp = tmat.materialize(tcfg, sh, tmesh, **kw_t)
            assert tp.describe() == jp.describe(), (sh.name, kw_t)
            assert tp.dp_degree == jp.dp_degree
            assert tmat.estimate_bytes_per_device(tcfg, sh, tp) == \
                jmat.estimate_bytes_per_device(jcfg, jsh, jp)


@pytest.mark.parametrize("mesh_i", [0, 1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_escalate_chain_matches_reference(arch, mesh_i):
    jcfg, tcfg = _cfgs(arch, False)
    jmesh, tmesh = MESHES[mesh_i]
    for sh in ALL_SHAPES:
        jp = jmat.materialize(jcfg, _jshape(sh), jmesh)
        tp = tmat.materialize(tcfg, sh, tmesh)
        for _ in range(20):
            jp = jmat.escalate(jp, jcfg, _jshape(sh), 1 << 60)
            tp = tmat.escalate(tp, tcfg, sh, 1 << 60)
            assert (tp is None) == (jp is None)
            if tp is None:
                break
            assert tp.describe() == jp.describe()
        else:
            pytest.fail("escalation did not terminate")


def test_plan_layout_key_matches_reference():
    jcfg, tcfg = _cfgs("tinyllama-1.1b", False)
    jmesh, tmesh = MESHES[1]
    for sh in ALL_SHAPES:
        jp = jmat.materialize(jcfg, _jshape(sh), jmesh)
        tp = tmat.materialize(tcfg, sh, tmesh)
        assert tcc.plan_layout_key(tcfg.name, sh.name, tmesh.name, tp) == \
            jcc.plan_layout_key(jcfg.name, sh.name, jmesh.name, jp)
    # notes and the estimate are not part of the layout
    tp2 = dataclasses.replace(tp, notes=["x"], est_bytes_per_device=1)
    assert tcc.plan_layout_key("a", "s", "m", tp2) == \
        tcc.plan_layout_key("a", "s", "m", tp)
    tp3 = dataclasses.replace(tp, microbatch=tp.microbatch * 2)
    assert tcc.plan_layout_key("a", "s", "m", tp3) != \
        tcc.plan_layout_key("a", "s", "m", tp)


def test_compile_cache_single_flight_and_hits(tmp_path):
    import threading
    cc = tcc.CompileCache(persistent_dir=str(tmp_path / "cache"))
    assert (tmp_path / "cache").is_dir()
    calls, gate = [], threading.Event()

    def build():
        calls.append(1)
        gate.wait(5)
        return "step"

    threads = [threading.Thread(target=cc.get_or_compile, args=("k", build))
               for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert cc.get_or_compile("k", build) == "step" and len(calls) == 1
    assert cc.stats["misses"] == 1 and cc.stats["hits"] == 4
    cc.prewarm("k2", lambda: "next").join()
    assert cc.contains("k2") and cc.stats["prewarmed"] == 1


# ---------------------------------------------------------------------------
# the two-level scheduler
# ---------------------------------------------------------------------------

def _replay(mod, hist_mod, seed):
    """A seeded trace of submit / scale_up / scale_down / park / unpark /
    cancel / finish over three pods, recorded after every operation."""
    rng = np.random.default_rng(seed)
    hist = hist_mod.HistoryStore()
    for app, peak in (("a0", 90), ("a1", 20), ("a2", 300)):
        hist.observe(app, "job", "bytes", peak * GB)
    pods = [mod.PodState("p0", 8, 16 * GB), mod.PodState("p1", 4, 16 * GB),
            mod.PodState("p2", 16, 16 * GB)]
    sched = mod.GlobalScheduler(pods, hist)
    jobs, log = [], []
    for i in range(300):
        op = rng.integers(0, 7)
        live = [j for j in jobs if j.state == "running"]
        if op <= 1 or not live:
            j = mod.Job(f"j{i}", f"a{rng.integers(0, 4)}", "train",
                        int(rng.integers(1, 120)) * GB, 1)
            jobs.append(j)
            log.append(("submit", sched.submit(j)))
        else:
            j = live[int(rng.integers(0, len(live)))]
            amount = int(rng.integers(1, 40)) * GB
            if op == 2:
                log.append(("up", sched.scale_up(j, amount)))
            elif op == 3:
                log.append(("down", sched.scale_down(j, amount)))
            elif op == 4:
                log.append(("park", sched.park(j, keep_bytes=amount)))
            elif op == 5:
                log.append(("unpark", sched.unpark(j, amount)))
            else:
                sched.finish(j)
                log.append(("finish", j.job_id))
        pend = [j for j in jobs if j.state == "pending"]
        if pend and rng.random() < 0.1:
            log.append(("cancel", sched.cancel(pend[0])))
        log.append((
            {n: (ps.pod.free_bytes, ps.pod.reserved_bytes,
                 sorted(ps.pod.running)) for n, ps in sched.pods.items()},
            dict(sched.reservations),
            [j.job_id for j in sched.pending],
            [(j.job_id, j.pod, j.state, j.demand_bytes, j.peak_bytes)
             for j in jobs]))
    return log, {k: h.to_json() for k, h in hist._hists.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_replay_matches_reference(seed):
    assert _replay(tsched, thist, seed) == _replay(jsched, jhist, seed)


def test_scheduler_places_components_like_reference():
    jcfg, tcfg = _cfgs("zamba2-2.7b", True)
    sh = REDUCED_SHAPES["train"]
    out = []
    for mod, graph, cfg, shape in (
            (tsched, tgraph, tcfg, sh), (jsched, jgraph, jcfg, _jshape(sh))):
        sched = mod.GlobalScheduler([mod.PodState("p", 1, 80 * GB)])
        job = mod.Job("j", cfg.name, "train", GB, 1,
                      graph=graph.build_resource_graph(cfg, shape))
        sched.submit(job)
        out.append(sched.pods["p"].placements["j"])
    assert out[0] == out[1] and "shared/sharded" in out[0].values()


# ---------------------------------------------------------------------------
# recovery helpers
# ---------------------------------------------------------------------------

def test_recovery_helpers_match_reference():
    rng = np.random.default_rng(4)
    walls = list(rng.uniform(0.9, 1.1, 30)) + [5.0, 1.0, 9.0]
    jw, tw = jrec.StragglerWatchdog(), trec.StragglerWatchdog()
    assert [tw.observe(i, w) for i, w in enumerate(walls)] == \
        [jw.observe(i, w) for i, w in enumerate(walls)]
    assert tw.flags == jw.flags and tw.flags[0][:2] == (30, 5.0)

    ct = trec.CutTracker()
    assert ct.replay_span(7) == (0, 7)
    ct.record(trec.RecoveryPoint(4, "/ckpt/4", 4, "h100"))
    assert ct.replay_span(7) == (4, 3) and ct.latest().step == 4

    meshes = [m for _, m in MESHES]
    pol = trec.ElasticPolicy(meshes)
    assert pol.grow() is None and pol.shrink() is meshes[1]
    assert pol.current_mesh() is meshes[1] and pol.grow() is meshes[0]

    jcfg, tcfg = _cfgs("tinyllama-1.1b", False)
    sh = SHAPES["train_4k"]
    for jm, tm in MESHES:
        assert trec.elastic_replan(tcfg, sh, tm).describe() == \
            jrec.elastic_replan(jcfg, JAX_SHAPES["train_4k"], jm).describe()

    inj = trec.FailureInjector((2,))
    inj.maybe_fail(1)
    with pytest.raises(RuntimeError, match="step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)
    assert inj.injected == [2]
    assert math.isfinite(tw.hist.quantile(0.99))
