"""The port's autoscale control plane and idle parking against the JAX
package's, on CPU.

Each case runs the reference's cluster and the port's on the same
explicit inputs, with ``pods`` given on both sides (the port's default is
one pod, the reference's two):

* the control plane with the ``NullExecutor`` (the reference's cases of
  ``tests/test_autoscale.py``: windows, policies, quota resize and
  rebalancing, parking's accounting, the tick-driven controller) and of
  ``tests/test_router.py`` (scale-to-zero is a park, the autoscaled
  replica count and batch width, predictive unparking): every
  receipt (without its ``parked_s``), controller log (without ``t``),
  page id, free list, quota, scheduler byte count and stats EQUAL, on one
  explicit pod of the same size;
* parking with real weights: the reference's ``JaxExecutor`` against the
  port's ``TorchExecutor(device="cpu")`` bound with the reference's
  weights (``tests/test_autoscale.py``'s warm-restart cases on the dense
  and paged backends and on reduced gemma3-12b's wrapped rings,
  ``tests/test_kv_alias.py``'s aliased park cases and
  ``tests/test_prefix_cache.py``'s re-attach): receipts and tokens equal
  (a token may flip only where the port's top-2 logit gap is below
  ``TIE_GAP``); the two executors account bytes differently (the port's
  grant grows to what the app holds on its device), so there the
  reference's relations hold instead: the bytes freed are the job's, and
  no byte leaks across cycles.  Port only: after a park the runner's
  ``params`` (and the paged runner's ``layers``) are None, the host
  snapshot holds bf16 as its uint16 bits beside its logical dtype, and an
  unpark restores every weight tensor bit-equal;
* the rest of the runtime's surface: ``runtime/simulate.py``'s trace
  replay (its counts, capacities and completion order equal) and
  ``serving/serve_step.py``'s prefill and greedy decode steps (the
  reference's tokens from its weights).
"""

import types

import jax
import numpy as np
import pytest
import torch

import repro.autoscale as jax_auto
import repro.core.scheduler as jax_sched
from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.history import HistoryStore as JaxHistory
from repro.models import ImplConfig, build_model
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import JaxExecutor
from repro.runtime import NullExecutor as JaxNull
from repro.runtime import ScalePolicy as JaxScale
from repro.runtime import ServeOptions as JaxOpts
from repro.runtime import replay_trace as jax_replay
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import tenancy as jax_tenancy
import repro_torch.autoscale as torch_auto
from repro_torch.bridge import params_from_jax
from repro_torch.core.history import HistoryStore
from repro_torch.core.scheduler import PodState
from repro_torch.runtime import (Application, Cluster, NullExecutor,
                                 ScalePolicy, ServeOptions, TorchExecutor)
from repro_torch.runtime import measure_cluster_throughput as torch_throughput
from repro_torch.runtime import replay_trace as torch_replay
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import kv_cache as torch_kv
from repro_torch.serving import tenancy as torch_tenancy
from repro_torch.serving.model_runner import _Leaf

GB = 1 << 30
PAGE = torch_kv.PAGE_SIZE
TIE_GAP = 1e-2                  # CPU rule: a flip only below this top-2 gap

JAX = types.SimpleNamespace(
    Cluster=JaxCluster, App=JaxApp, Opts=JaxOpts, Scale=JaxScale,
    Null=JaxNull,
    History=JaxHistory, Pod=jax_sched.PodState, Request=jax_kv.Request,
    Engine=jax_engine.ServingEngine,
    SharedPagePool=jax_tenancy.SharedPagePool, auto=jax_auto)
PORT = types.SimpleNamespace(
    Cluster=Cluster, App=Application, Opts=ServeOptions, Scale=ScalePolicy,
    Null=NullExecutor,
    History=HistoryStore, Pod=PodState, Request=torch_kv.Request,
    Engine=torch_engine.ServingEngine,
    SharedPagePool=torch_tenancy.SharedPagePool, auto=torch_auto)


def _both(case):
    """Run ``case(pkg)`` through the reference and the port: equal."""
    want, got = case(JAX), case(PORT)
    assert got == want
    return got


def _untimed(d):
    """A receipt or controller entry without its clock readings."""
    if isinstance(d, list):
        return [_untimed(x) for x in d]
    return {k: v for k, v in d.items() if k not in ("t", "parked_s")}


def _null_cluster(pkg, pool_pages, hbm=80 * GB):
    return pkg.Cluster([pkg.Pod("pod0", 1, hbm)], history=pkg.History(),
                       executor=pkg.Null(), pool_pages=pool_pages)


def _serve(pkg, cluster, name=None, **opts):
    return cluster.submit(pkg.App.serve(
        "tinyllama-1.1b", reduced=True, name=name,
        serve=pkg.Opts(**opts)))


def _capacity(cluster):
    pod = cluster.scheduler.pods["pod0"].pod
    return pod.free_bytes, pod.reserved_bytes


# ---------------------------------------------------------------------------
# windows and policies (tests/test_autoscale.py:96, :135, :157)
# ---------------------------------------------------------------------------

def _window_stats(admitted, denials, queue_len=0, running=0):
    return {"admitted": admitted, "completed": 0, "rejected": 0,
            "preempted": 0, "decode_steps": admitted, "prefills": 0,
            "tokens_generated": admitted * 2, "ttft_s_sum": 0.0,
            "ttft_count": 0, "decode_s_sum": 0.0,
            "queue_len": queue_len, "num_running": running,
            "pool": {"grants": 0, "grant_pages": 0, "denials": denials,
                     "scaleups": 0, "released": 0},
            "pool_utilization": 0.5, "pool_used_pages": 4,
            "pool_quota_pages": 8}


def _metrics_window(pkg):
    w = pkg.auto.MetricsWindow(alpha=1.0)
    out = []
    for stats, now in ((_window_stats(0, 0), 0.0),
                       (_window_stats(4, 2), 2.0),
                       (_window_stats(4, 2), 3.0),
                       (_window_stats(4, 2, queue_len=1), 4.0)):
        out.append((dict(w.observe(stats, now=now)), w.idle_s))
    return out


def _target_tracking(pkg):
    _, h = _handle_with_traffic(pkg, "tt")
    pol = pkg.auto.TargetTracking(denial_target_per_s=1.0,
                                  shrink_utilization=0.25)
    w = pkg.auto.MetricsWindow(alpha=1.0)
    out = []
    for demand, rates in (
            (None, {"denials_per_s": 5.0, "pool_utilization": 0.9}),
            (None, {"denials_per_s": 0.0, "pool_utilization": 0.05}),
            # growth is capped at max_demand_factor x the estimate
            (int(2.0 * h.app.capped_demand(h.app.estimate_demand())),
             {"denials_per_s": 5.0, "pool_utilization": 0.9}),
            # an EWMA denial residue (never exactly 0) must not block shrink
            (h.app.estimate_demand(),
             {"denials_per_s": 0.01, "pool_utilization": 0.05})):
        if demand is not None:
            h.job.demand_bytes = demand
        w.rates = rates
        d = pol.decide(w, h)
        out.append((d.action, d.amount_bytes, d.reason))
    assert [a for a, _, _ in out] == ["scale_up", "scale_down", "none",
                                      "scale_down"]
    return out


def _handle_with_traffic(pkg, name):
    cluster = _null_cluster(pkg, 32)
    return cluster, _serve(pkg, cluster, name, max_batch=4)


def _idle_parker(pkg):
    _, h = _handle_with_traffic(pkg, "ip")
    pol = pkg.auto.IdleParker(idle_s=10.0)
    w = pkg.auto.MetricsWindow()
    w.now, w.last_active_t = 100.0, 95.0
    w.rates = {"queue_len": 0, "num_running": 0}
    out = [pol.decide(w, h)]                      # only 5 s idle
    w.last_active_t = 85.0
    out.append(pol.decide(w, h))
    w.rates = {"queue_len": 1, "num_running": 0}  # queued work: no park
    out.append(pol.decide(w, h))
    assert [d.action for d in out] == ["none", "park", "none"]
    return [(d.action, d.reason) for d in out]


# ---------------------------------------------------------------------------
# the rebalancer's lever and the rebalancer (:174, :197, :558)
# ---------------------------------------------------------------------------

def _resize_quota_shrink(pkg):
    shared = pkg.SharedPagePool(32)
    view = shared.view("shrink-me", quota=16, policy="fixed",
                       fixed_init_pages=2, fixed_step_pages=1)
    eng = pkg.Engine(view, max_batch=4)
    for i in range(4):
        eng.submit(pkg.Request(f"r{i}", PAGE * 2 - 4, 8))
    eng.step()
    out = [view.used, sorted(shared.free)]
    preempted = view.resize_quota(3)
    assert preempted >= 1 and view.used <= 3
    assert shared.used_pages == view.used, "pages stranded on the view"
    out += [preempted, view.used, shared.used_pages, eng.stats.preempted,
            sorted(shared.free)]
    stats = eng.run_to_completion(max_steps=10_000)
    assert stats.completed == 4 and shared.used_pages == 0
    return out + [stats.as_dict()["completed"], sorted(shared.free)]


def _quota_rebalancer(pkg):
    shared = pkg.SharedPagePool(64, history=pkg.History())
    busy = shared.view("busy", quota=21, policy="fixed")
    idle = shared.view("idle", quota=21, policy="fixed")
    eng_busy = pkg.Engine(busy, max_batch=8)
    pkg.Engine(idle, max_batch=8)
    for i in range(6):
        eng_busy.submit(pkg.Request(f"b{i}", PAGE * 2 - 4, 64))
    for _ in range(3):
        eng_busy.step()
    reb = pkg.auto.QuotaRebalancer(alpha=1.0, headroom=2.0, min_pages=2)
    wb, wi = pkg.auto.MetricsWindow(), pkg.auto.MetricsWindow()
    wb.window = {"pool": {"denials": 0}}
    wi.window = {"pool": {"denials": 0}}
    quotas = reb.rebalance(shared, {"busy": wb, "idle": wi})
    assert quotas["busy"] > quotas["idle"] and quotas["idle"] <= 4
    return [busy.used, quotas, busy.quota, idle.quota]


def _rebalancer_per_pod(pkg):
    reb = pkg.auto.QuotaRebalancer(alpha=0.5, headroom=2.0, min_pages=2)
    pod0, pod1 = pkg.SharedPagePool(64), pkg.SharedPagePool(64)
    for shared, used in ((pod0, 20), (pod1, 0)):
        api = shared.view("api", quota=16, policy="fixed")
        other = shared.view("other", quota=16, policy="fixed")
        api.used = used                  # direct accounting for the test
        pkg.Engine(api, max_batch=1)
        pkg.Engine(other, max_batch=1)
    w = {"api": pkg.auto.MetricsWindow(), "other": pkg.auto.MetricsWindow()}
    q0 = reb.rebalance(pod0, w, scope="pod0")
    q1 = reb.rebalance(pod1, w, scope="pod1")
    again = reb.rebalance(pod0, w, scope="pod0")
    assert q0["api"] >= 40 and q1["api"] <= 4 and again["api"] >= 40
    return [q0, q1, again]


# ---------------------------------------------------------------------------
# parking: accounting (:226, :265, :299, :322, :363, :434)
# ---------------------------------------------------------------------------

def _park_releases_pages_and_bytes(pkg):
    cluster = _null_cluster(pkg, 32)
    h = _serve(pkg, cluster, "parkme", max_batch=4)
    free0 = cluster.capacity()["pod0"]["free_bytes"]
    demand = h.job.demand_bytes
    for i in range(3):
        h.submit_request(pkg.Request(f"r{i}", PAGE * 2 - 4, 200))
    for _ in range(3):
        h.step()
    shared = cluster.pod_pool("pod0")
    pages_held = shared.used_pages
    receipt = h.park()
    assert receipt["freed_pages"] == pages_held > 0
    assert shared.used_pages == 0 and h.job.demand_bytes == 0
    cap = cluster.capacity()["pod0"]
    assert cap["free_bytes"] == free0 + demand
    assert cap["reserved_bytes"] >= demand, "park pre-marks a reservation"
    step = h.step()
    assert step["parked"] is True and step["alive"] is False
    view = h.engine.pool
    assert shared.fair_share(view) == 0.0
    out = [_untimed(receipt), cap, sorted(shared.free), view.parked,
           h.num_replicas]
    unpark = h.unpark()
    assert not h.parked and h.job.demand_bytes == demand
    assert shared.used_pages == pages_held, "pages re-granted"
    out += [_untimed(unpark), sorted(shared.free), view.parked]
    stats = h.run(max_steps=50_000)
    assert stats["completed"] == 3
    h.release()
    return out + [cluster.capacity()]


def _park_cycles_no_byte_leak(pkg):
    cluster = _null_cluster(pkg, 16)
    h = _serve(pkg, cluster, "cycler", max_batch=2)
    for i in range(2):
        h.submit_request(pkg.Request(f"r{i}", PAGE - 4, 400))
    for _ in range(2):
        h.step()
    shared = cluster.pod_pool("pod0")
    (free0, reserved0), used0 = _capacity(cluster), shared.used_pages
    demand0 = h.job.demand_bytes
    out = []
    for _ in range(5):
        out.append(_untimed(h.park()))
        assert _capacity(cluster) == (free0 + demand0, reserved0 + demand0)
        assert shared.used_pages == 0
        out.append(_untimed(h.unpark()))
        assert _capacity(cluster) == (free0, reserved0), "byte leak"
        assert shared.used_pages == used0 and h.job.demand_bytes == demand0
    assert h.run(max_steps=50_000)["completed"] == 2
    h.release()
    assert _capacity(cluster) == (80 * GB, 0)
    return out


def _parked_reservation_is_low_priority(pkg):
    demand = 1 << 20
    cluster = pkg.Cluster(pods=[pkg.Pod("pod0", 1, 2 * demand)],
                          executor=pkg.Null(), pool_pages=8)
    a = cluster.submit(pkg.App.synthetic("a", "serve", demand))
    # synthetic apps bind nothing: give the handle an engine to drain
    a.exec_state["engine"] = pkg.Engine(cluster.pod_pool("pod0").view("a"))
    out = [_untimed(a.park()), cluster.capacity()]
    b = cluster.submit(pkg.App.synthetic("b", "serve", 2 * demand))
    assert b.state == "running", "reservation must be low-priority"
    with pytest.raises(RuntimeError, match="cannot unpark"):
        a.unpark()
    assert a.parked, "a failed unpark must leave the app parked"
    b.release()
    out.append(_untimed(a.unpark()))
    assert a.job.demand_bytes == demand
    a.release()
    return out + [cluster.capacity()]


def _park_release_keeps_sizing_history(pkg):
    hist = pkg.History()
    cluster = pkg.Cluster([pkg.Pod("pod0", 1, 80 * GB)], history=hist,
                          executor=pkg.Null(), pool_pages=8)
    h = _serve(pkg, cluster, "poison", max_batch=2)
    demand0 = h.job.demand_bytes
    h.park()
    assert h.job.demand_bytes == 0
    h.release()
    rec = hist.get("poison", "job", "bytes")
    assert rec is not None and rec.last == demand0
    return rec.to_json()


def _park_rejects_wrong_states(pkg):
    cluster = _null_cluster(pkg, 8)
    t = cluster.submit(pkg.App.train("tinyllama-1.1b", reduced=True))
    with pytest.raises(ValueError, match="serve") as e1:
        t.park()
    t.release()
    s = cluster.submit(pkg.App.serve("tinyllama-1.1b", reduced=True))
    s.park()
    with pytest.raises(RuntimeError, match="already parked") as e2:
        s.park()
    s.release()
    return [str(e1.value), str(e2.value)]


def _unpark_under_pool_pressure(pkg):
    cluster = _null_cluster(pkg, 8)
    a = _serve(pkg, cluster, "parked", max_batch=2)
    b = _serve(pkg, cluster, "squatter", max_batch=8)
    for i in range(2):
        a.submit_request(pkg.Request(f"a{i}", PAGE * 2 - 4, 60))
    for _ in range(2):
        a.step()
    out = [_untimed(a.park())]
    for i in range(8):                  # the squatter takes the whole pool
        b.submit_request(pkg.Request(f"b{i}", PAGE - 4, 60))
    for _ in range(3):
        b.step()
    shared = cluster.pod_pool("pod0")
    assert len(shared.free) == 0
    info = a.unpark()
    assert info["restored_requests"] + info["requeued_requests"] == 2
    out += [_untimed(info), sorted(shared.free)]
    for _ in range(50_000):
        alive_a = a.step()["alive"]
        alive_b = b.step()["alive"]
        if not (alive_a or alive_b):
            break
    done = [a.serving_stats()["completed"], b.serving_stats()["completed"]]
    assert done == [2, 8]
    a.release()
    b.release()
    assert sorted(shared.free) == list(range(8))
    return out + done


# ---------------------------------------------------------------------------
# the controller (:340, :476, :503, :528, :579)
# ---------------------------------------------------------------------------

def _default_chain_parks_before_grinding_down(pkg):
    chain = pkg.auto.default_policies(idle_park_s=2.0)
    assert isinstance(chain[0], pkg.auto.IdleParker)
    cluster = _null_cluster(pkg, 8, hbm=512 * GB)
    cluster.enable_autoscale(idle_park_s=2.0, confirm_ticks=1)
    h = _serve(pkg, cluster, "big", max_batch=2)
    # a huge demand: thousands of 64 MiB shrink steps available
    demand0 = h.job.demand_bytes
    h.job.demand_bytes = 256 * GB
    cluster.scheduler.pods["pod0"].pod.free_bytes -= 256 * GB - demand0
    for t in range(5):
        cluster.tick(now=float(t))
    assert h.parked, "must park at idle_s, not shrink step by step first"
    log = _untimed(cluster.autoscaler.log)
    h.unpark()
    h.release()
    return log


def _controller_parks_idle_app_and_unparks_on_submit(pkg):
    cluster = _null_cluster(pkg, 32)
    cluster.enable_autoscale(idle_park_s=5.0, confirm_ticks=2)
    h = _serve(pkg, cluster, "ticker", max_batch=4)
    for i in range(3):
        h.submit_request(pkg.Request(f"r{i}", 48, 8))
    t = 0.0
    while h.step()["alive"]:
        cluster.tick(now=t)
        t += 1.0
    assert not h.parked
    for _ in range(12):                 # idle ticks
        cluster.tick(now=t)
        t += 1.0
    assert h.parked, "the tick loop must park an idle app"
    parks = [a for a in cluster.autoscaler.log if a["action"] == "park"]
    assert len(parks) == 1 and parks[0]["app"] == "ticker"
    h.submit_request(pkg.Request("wake", 48, 8))
    assert not h.parked, "submit_request must unpark transparently"
    stats = h.run(max_steps=50_000)
    assert stats["completed"] == 4
    log = _untimed(cluster.autoscaler.log)
    h.release()
    return log


def _controller_hysteresis_and_cooldown(pkg):
    cluster = _null_cluster(pkg, 16)
    ctl = cluster.enable_autoscale(denial_target_per_s=0.5,
                                   confirm_ticks=3, cooldown_up_s=10.0)
    h = _serve(pkg, cluster, "hyst", max_batch=4, quota_pages=2)
    for i in range(6):
        h.submit_request(pkg.Request(f"r{i}", PAGE - 4, 130))
    ups = []
    for t in range(8):
        for _ in range(2):
            h.step()
        ups += [a for a in ctl.tick(now=float(t))
                if a["action"] == "scale_up"]
    # confirm_ticks=3 delays the first action to the 3rd confirming
    # tick; cooldown_up_s=10 then allows no second one within 8 ticks
    assert len(ups) == 1 and ups[0]["t"] >= 2.0
    h.release()
    return [ups, _untimed(ctl.log)]


def _controller_never_scales_a_parked_app(pkg):
    cluster = _null_cluster(pkg, 4)
    ctl = cluster.enable_autoscale(idle_park_s=3.0, confirm_ticks=1,
                                   denial_target_per_s=0.5)
    h = _serve(pkg, cluster, "spiky", max_batch=4, quota_pages=2)
    for i in range(4):      # quota-starved: builds a strong denial EWMA
        h.submit_request(pkg.Request(f"r{i}", PAGE - 4, 130))
    t = 0.0
    while h.step()["alive"]:
        cluster.tick(now=t)
        t += 1.0
    for _ in range(10):     # idle: parks, then the EWMA keeps decaying
        cluster.tick(now=t)
        t += 1.0
    assert h.parked and h.job.demand_bytes == 0
    t_park = next(x["t"] for x in ctl.log if x["action"] == "park")
    assert not any(a["action"] in ("scale_up", "scale_down")
                   and a["t"] > t_park for a in ctl.log if "t" in a)
    h.release()
    return _untimed(ctl.log)


def _disabled_autoscale_tick_is_noop(pkg):
    cluster = pkg.Cluster(pods=1, executor=pkg.Null())
    return [cluster.tick(), cluster.autoscaler]


# ---------------------------------------------------------------------------
# replicas: scale-to-zero and the autoscaled dimensions
# (tests/test_router.py:183, :214, :239, :257)
# ---------------------------------------------------------------------------

def _reqs(pkg, n, prefix="r", prompt=PAGE - 4, max_new=6):
    return [pkg.Request(f"{prefix}{i}", prompt, max_new) for i in range(n)]


def _completed(h):
    return h.stats_view.cumulative()["completed"]


def _scale_to_zero_is_park(pkg):
    cluster = _null_cluster(pkg, 64)
    h = _serve(pkg, cluster, "zero", max_batch=2, replicas=2,
               scale=pkg.Scale(min_replicas=0, max_replicas=3))
    for r in _reqs(pkg, 4, prefix="a"):
        h.submit_request(r)
    h.run(max_steps=1000)
    assert h.num_replicas == 2
    receipt = h.park()
    # park first scaled the set to one replica (nothing in flight, so
    # nothing to migrate), then drained it
    assert h.parked and h.num_replicas == 0
    assert receipt["migrated_requests"] == 0
    assert len(h.replica_set.replicas) == 1
    for r in _reqs(pkg, 2, prefix="b"):   # demand-driven restart
        h.submit_request(r)
    assert not h.parked and h.num_replicas == 1
    h.add_replica()
    h.run(max_steps=1000)
    done = _completed(h)
    assert done == 6        # retired replicas' counters folded in
    h.release()
    return [_untimed(receipt), done, cluster.capacity()]


def _adds_replicas_on_queue_depth(pkg):
    cluster = _null_cluster(pkg, 64)
    h = _serve(pkg, cluster, "scaleout", max_batch=2,
               scale=pkg.Scale(max_replicas=3, target_queue_per_replica=1.0))
    ctl = cluster.enable_autoscale(confirm_ticks=1, idle_park_s=1e9)
    for r in _reqs(pkg, 8):
        h.submit_request(r)
    cluster.tick(now=0.0)
    cluster.tick(now=1.0)
    assert "add_replica" in [a["action"] for a in ctl.log]
    assert h.num_replicas >= 2
    log = _untimed(ctl.log)
    h.run(max_steps=1000)
    assert _completed(h) == 8
    h.release()
    return log


def _widens_batch_on_occupancy(pkg):
    cluster = _null_cluster(pkg, 64)
    h = _serve(pkg, cluster, "widen", max_batch=2,
               scale=pkg.Scale(batch_max=8))
    ctl = cluster.enable_autoscale(confirm_ticks=1, idle_park_s=1e9)
    for r in _reqs(pkg, 6):
        h.submit_request(r)
    h.step()                    # both slots busy: occupancy 1.0, queue > 0
    cluster.tick(now=0.0)       # baseline observation
    cluster.tick(now=1.0)
    assert [a for a in ctl.log if a["action"] == "grow_batch"]
    assert h.replica_set.max_batch == 4      # doubled, inside batch_max
    h.run(max_steps=1000)
    assert _completed(h) == 6
    h.release()
    return _untimed(ctl.log)


def _predictive_unpark(pkg):
    cluster = _null_cluster(pkg, 64)
    h = _serve(pkg, cluster, "periodic", max_batch=2,
               scale=pkg.Scale(min_replicas=0, max_replicas=1))
    ctl = cluster.enable_autoscale(confirm_ticks=1, idle_park_s=1e9)
    for i, t in enumerate((0.0, 10.0, 20.0)):   # arrivals every 10 s
        h.submit_request(pkg.Request(f"p{i}", PAGE - 4, 4))
        h.run(max_steps=200)
        cluster.tick(now=t)
    h.park()
    cluster.tick(now=25.0)                      # well before the forecast
    assert h.parked
    cluster.tick(now=29.5)                      # 29.5 + lead 1.0 >= 30.0
    assert not h.parked
    assert "unpark" in [a["action"] for a in ctl.log]
    h.release()
    return _untimed(ctl.log)


@pytest.mark.parametrize("case", [
    _metrics_window, _target_tracking, _idle_parker,
    _resize_quota_shrink, _quota_rebalancer, _rebalancer_per_pod,
    _park_releases_pages_and_bytes, _park_cycles_no_byte_leak,
    _parked_reservation_is_low_priority, _park_release_keeps_sizing_history,
    _park_rejects_wrong_states, _unpark_under_pool_pressure,
    _default_chain_parks_before_grinding_down,
    _controller_parks_idle_app_and_unparks_on_submit,
    _controller_hysteresis_and_cooldown,
    _controller_never_scales_a_parked_app,
    _disabled_autoscale_tick_is_noop,
    _scale_to_zero_is_park, _adds_replicas_on_queue_depth,
    _widens_batch_on_occupancy, _predictive_unpark,
])
def test_control_plane_matches_reference(case):
    _both(case)


# ---------------------------------------------------------------------------
# parking with real weights: the JaxExecutor against the TorchExecutor
# ---------------------------------------------------------------------------

class BridgedExecutor(TorchExecutor):
    """Binds every application with the reference's weights for its
    config name, and has each runner record its top-2 logit gaps."""

    def __init__(self, params_by_name, **kw):
        super().__init__(**kw)
        self.params_by_name = params_by_name

    def init_params(self, handle):
        cfg = handle.app.config
        return params_from_jax(self.params_by_name[cfg.name], cfg,
                               self.device)

    def build_replica(self, handle, idx):
        rep = super().build_replica(handle, idx)
        rep.runner.margins = {}
        return rep


@pytest.fixture(scope="module")
def params():
    """The reference's reduced weights (its executors' init, seed 0)."""
    return {name: jax.tree.map(np.asarray, build_model(
        jax_reduced(jax_get_config(name)), ImplConfig(remat="none"))
        .init_params(jax.random.PRNGKey(0)))
        for name in ("tinyllama-1.1b", "gemma3-12b")}


def _cluster(pkg, params, pool_pages=None):
    ex = (JaxExecutor(seed=0) if pkg is JAX
          else BridgedExecutor(params, device="cpu"))
    return pkg.Cluster([pkg.Pod("pod0", 1, 80 * GB)], history=pkg.History(),
                       executor=ex, pool_pages=pool_pages)


def _check_tokens(want, got, margins):
    """Equal tokens, except that a request may part from the reference
    where the port's top-2 logit gap is below ``TIE_GAP``."""
    assert want.keys() == got.keys()
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w), rid
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                assert margins[rid][j] < TIE_GAP, (
                    f"{rid} token {j}: {b} vs {a} at a top-2 gap of "
                    f"{margins[rid][j]:.3e}")
                break


def _margins(handles):
    out = {}
    for h in handles:
        for rid, gaps in (h.runner.margins or {}).items():
            out.setdefault(rid, []).extend(gaps)
    return out


def _host_snapshot_checks(h, runner_state):
    """Port only: the parked runner holds no weights on the device, and
    its snapshot keeps bf16 as uint16 bits beside the logical dtype."""
    runner = h.runner
    assert runner.params is None and h.exec_state["params"] is None
    if runner.backend == "paged":
        assert runner.layers is None
    else:
        assert runner.cache is None
    leaves, skeleton = runner_state["params"]
    assert isinstance(skeleton["embed"]["tok"], _Leaf)
    arr, logical = leaves[skeleton["embed"]["tok"].index]
    assert logical == "bfloat16" and arr.dtype == np.uint16


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return a == b


def _serve_with_park(pkg, params, backend, park_cycles, *, n=3, prompt=200,
                     max_new=8, arch="tinyllama-1.1b", steps_before_park=3):
    """The reference's ``_serve_with_park``: ``n`` explicit prompts,
    ``steps_before_park`` steps, ``park_cycles`` park/unpark cycles, run
    to the end.  Returns (completed, receipts, tokens, margins)."""
    cluster = _cluster(pkg, params)
    h = cluster.submit(pkg.App.serve(
        arch, reduced=True, name=f"park-{backend}",
        serve=pkg.Opts(max_batch=4, pool_pages=32, cache_len=512,
                       policy="history", backend=backend)))
    rng = np.random.default_rng(7)
    reqs = [pkg.Request(f"r{i}", prompt, max_new, prompt_tokens=tuple(
        int(t) for t in rng.integers(0, 256, prompt))) for i in range(n)]
    for r in reqs:
        h.submit_request(r)
    for _ in range(steps_before_park):
        h.step()
    receipts = []
    for _ in range(park_cycles):
        before = h.job.demand_bytes
        if pkg is PORT:
            held = {k: v.clone() for k, v in
                    _flat(h.runner.params).items()}
        receipt = h.park()
        assert receipt["freed_bytes"] == before     # the job's bytes
        if pkg is PORT:
            _host_snapshot_checks(h, h.exec_state["parked"].runner_state)
        else:
            assert h.runner.params is None
        unpark = h.unpark()
        assert unpark["reacquired_bytes"] == receipt["freed_bytes"]
        assert h.job.demand_bytes == before
        if pkg is PORT:
            assert _tree_equal(held, _flat(h.runner.params))
            if backend == "paged":
                assert h.runner.layers is not None
        receipts.append([_untimed(receipt), _untimed(unpark)])
    stats = h.run(max_steps=5_000)
    tokens = {r.req_id: list(r.output_tokens) for r in reqs
              if r.output_tokens is not None}
    margins = _margins([h]) if pkg is PORT else None
    h.release()
    return stats["completed"], receipts, tokens, margins


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _flat(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _no_bytes(receipt):
    """A receipt without its clock readings and byte counts."""
    return {k: v for k, v in _untimed(receipt).items()
            if k not in ("freed_bytes", "reacquired_bytes")}


def _bytes_free(receipts):
    return [[_no_bytes(r) for r in c] for c in receipts]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_unpark_decode_token_identical(params, backend):
    """``tests/test_autoscale.py:407``: 0, 1 and 3 park cycles after 3
    steps give the same tokens in each package, the port's equal to the
    reference's; the receipts (bytes aside) equal the reference's."""
    runs = {}
    for pkg in (JAX, PORT):
        runs[pkg is PORT] = [_serve_with_park(pkg, params, backend, c)
                             for c in (0, 1, 3)]
    for got in runs.values():
        assert [c for c, _, _, _ in got] == [3, 3, 3]
        assert got[0][2] == got[1][2] == got[2][2], \
            f"{backend}: tokens diverged after park/unpark"
        assert all(len(t) == 9 for t in got[1][2].values())
    for want, got in zip(runs[False], runs[True]):
        assert _bytes_free(got[1]) == _bytes_free(want[1])
        _check_tokens(want[2], got[2], got[3])


def test_unpark_swa_ring_token_identical(params):
    """``tests/test_autoscale.py:419``: reduced gemma3-12b on ring pages,
    3 park cycles after 60 steps (length 259 > the 256-token ring space,
    so the parked rings hold wrapped state): tokens equal a run with no
    park in each package, the port's equal to the reference's."""
    kw = dict(arch="gemma3-12b", prompt=200, max_new=70,
              steps_before_park=60)
    out = {}
    for pkg in (JAX, PORT):
        calm = _serve_with_park(pkg, params, "paged", 0, **kw)
        parked = _serve_with_park(pkg, params, "paged", 3, **kw)
        assert calm[0] == parked[0] == 3
        assert calm[2] == parked[2], "ring contents diverged across a park"
        assert all(len(t) == 71 for t in parked[2].values())
        out[pkg is PORT] = parked
    assert _bytes_free(out[True][1]) == _bytes_free(out[False][1])
    _check_tokens(out[False][2], out[True][2], out[True][3])


# -- aliased tenants (tests/test_kv_alias.py:175, :220, :258) ----------------

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


def _paged_tenant(pkg, cluster, name):
    return cluster.submit(pkg.App.serve(
        "tinyllama-1.1b", reduced=True, name=name,
        serve=pkg.Opts(max_batch=2, backend="paged", policy="fixed")))


def _aliased_park(pkg, params, park_mid):
    cluster = _cluster(pkg, params, 16)
    t0 = _paged_tenant(pkg, cluster, "t0")
    t1 = _paged_tenant(pkg, cluster, "t1")
    r0 = _submit(pkg, t0, [("a", 200, 24, 1), ("b", 64, 24, 2)])
    r1 = _submit(pkg, t1, [("c", 200, 24, 3), ("d", 64, 24, 4)])
    for _ in range(3):
        t0.step()
        t1.step()
    seen = []
    if park_mid:
        shared = cluster.pod_pool("pod0")
        used_before = shared.used_pages
        receipt = t0.park()
        assert receipt["kv_arrays_dropped"] is False, \
            "the co-tenant still aliases the store"
        assert t0.runner.store.k_pages is not None
        assert shared.used_pages < used_before
        seen += [receipt, sorted(shared.free)]
        for _ in range(6):           # the co-tenant decodes meanwhile
            t1.step()
        seen += [t0.unpark(), sorted(shared.free)]
    _drive([t0, t1])
    for h in (t0, t1):
        assert h.serving_stats()["completed"] == 2
    toks = {r.req_id: list(r.output_tokens) for r in r0 + r1}
    margins = _margins([t0, t1]) if pkg is PORT else None
    t0.release()
    t1.release()
    return toks, margins, [_no_bytes(s) if isinstance(s, dict) else s
                           for s in seen]


def test_park_unpark_aliased_keeps_cotenant_arrays(params):
    """``tests/test_kv_alias.py:175``: parking one of two aliased tenants
    snapshots only its pages and keeps the store for the co-tenant; the
    tokens equal a run with no park, in each package and across them,
    and the receipts and free lists equal the reference's."""
    runs = {}
    for pkg in (JAX, PORT):
        calm, _, _ = _aliased_park(pkg, params, False)
        parked, margins, seen = _aliased_park(pkg, params, True)
        assert parked == calm, "park/unpark changed tokens under aliasing"
        runs[pkg is PORT] = (parked, margins, seen)
    assert runs[True][2] == runs[False][2]
    _check_tokens(runs[False][0], runs[True][0], runs[True][1])


def _all_parked_drop_arrays(pkg, params):
    cluster = _cluster(pkg, params, 16)
    a = _paged_tenant(pkg, cluster, "a")
    b = _paged_tenant(pkg, cluster, "b")
    ra = _submit(pkg, a, [("a0", 64, 12, 5)])
    rb = _submit(pkg, b, [("b0", 64, 12, 6)])
    for _ in range(2):
        a.step()
        b.step()
    store = a.runner.store
    out = [_no_bytes(a.park()), _no_bytes(b.park())]
    assert out[0]["kv_arrays_dropped"] is False     # b still active
    assert out[1]["kv_arrays_dropped"] is True      # last active tenant
    assert store.device_bytes() == 0
    out.append(_no_bytes(a.unpark()))        # revives the arrays
    assert store.k_pages is not None
    out.append(_no_bytes(b.unpark()))
    _drive([a, b])
    assert len(ra[0].output_tokens) == len(rb[0].output_tokens) == 13
    toks = {r.req_id: list(r.output_tokens) for r in ra + rb}
    margins = _margins([a, b]) if pkg is PORT else None
    b.park()                         # a release while the co-tenant is
    a.release()                      # parked drops the arrays again
    assert store.device_bytes() == 0
    b.unpark()
    b.release()
    assert not cluster.pod_pool("pod0").kv_stores
    return out, toks, margins


def _sole_tenant_park_drops_arrays(pkg, params):
    cluster = _cluster(pkg, params, 16)
    h = _paged_tenant(pkg, cluster, "solo")
    reqs = _submit(pkg, h, [("a", 200, 16, 7)])
    for _ in range(3):
        h.step()
    store = h.runner.store
    receipt = h.park()
    assert receipt["kv_arrays_dropped"] is True
    assert store.device_bytes() == 0 and store.k_pages is None
    out = [_no_bytes(receipt), _no_bytes(h.unpark())]
    assert store.k_pages is not None
    _drive([h])
    assert h.serving_stats()["completed"] == 1
    assert len(reqs[0].output_tokens) == 17
    toks = {r.req_id: list(r.output_tokens) for r in reqs}
    margins = _margins([h]) if pkg is PORT else None
    h.release()
    return out, toks, margins


@pytest.mark.parametrize("case", [_all_parked_drop_arrays,
                                  _sole_tenant_park_drops_arrays])
def test_last_active_tenant_takes_the_store(params, case):
    """``tests/test_kv_alias.py:220`` and ``:258``: the last active user
    of a store to park (or to be released while the rest are parked)
    drops its tensors, and any unpark revives them; receipts equal the
    reference's and tokens too."""
    want, got = case(JAX, params), case(PORT, params)
    assert got[0] == want[0]
    _check_tokens(want[1], got[1], got[2])


# -- the prefix cache's re-attach (tests/test_prefix_cache.py:392) ------------

def _overlap_requests(pkg, n, gen=4):
    shared = tuple((1 * 7919 + i * 31) % 211 for i in range(2 * PAGE + 25))
    out = []
    for i in range(n):
        toks = shared + tuple(((100 + i) * 7919 + j * 31) % 211
                              for j in range(70))
        out.append(pkg.Request(f"px{i}", len(toks), gen, prompt_tokens=toks))
    return out


def _prefix_park(pkg, params, disturb):
    cluster = _cluster(pkg, params, 64)

    def mk(name):
        return cluster.submit(pkg.App.serve(
            "tinyllama-1.1b", reduced=True, name=name,
            serve=pkg.Opts(max_batch=2, backend="paged", policy="fixed",
                           cache_len=1024, prefix_cache=True)))

    h = mk("parker")
    # a live same-model co-tenant keeps the store (and the cache content)
    # across the park; a sole tenant's park flushes the cache with it
    keeper = mk("keeper")
    warm = _overlap_requests(pkg, 2)
    h.submit_request(warm[0])
    while h.step()["alive"]:
        pass
    r = warm[1]
    h.submit_request(r)
    h.step()                              # hit + prefill, mid-decode
    assert r.shared_pages, "the second overlapping request must hit"
    park = h.park()
    if disturb == "flush":
        assert h.runner.prefix.flush() > 0, "parked pins must be dropped"
    receipt = h.unpark()
    if disturb == "flush":
        assert receipt["requeued_requests"] == 1
    else:
        assert receipt["restored_requests"] == 1
        assert h.runner.reattach_unpins == 0
    while h.step()["alive"]:
        pass
    toks = {q.req_id: list(q.output_tokens) for q in warm}
    margins = _margins([h]) if pkg is PORT else None
    h.release()
    keeper.release()
    return toks, margins, [_no_bytes(park), _no_bytes(receipt)]


def test_park_unpark_reattaches_or_recomputes(params):
    """The parked request re-pins its surviving prefix chain, or is
    requeued and recomputed when the cache was flushed meanwhile: tokens
    equal either way, in each package and across them."""
    runs = {}
    for pkg in (JAX, PORT):
        kept = _prefix_park(pkg, params, None)
        flushed = _prefix_park(pkg, params, "flush")
        assert kept[0] == flushed[0]
        runs[pkg is PORT] = (kept, flushed)
    for want, got in zip(runs[False], runs[True]):
        assert got[2] == want[2]
        _check_tokens(want[0], got[0], got[1])


# ---------------------------------------------------------------------------
# the rest of the runtime's surface: trace replay and the serving steps
# ---------------------------------------------------------------------------

def _trace_replay(pkg):
    """``tests/test_runtime.py``'s replay, on four explicit pods of 8 GiB
    so that some arrivals wait for a release."""
    cluster = pkg.Cluster([pkg.Pod(f"pod{i}", 1, 8 * GB) for i in range(4)],
                          executor=pkg.Null())
    apps = [pkg.App.synthetic(f"a{i % 8}", "serve", (1 + i % 4) * GB)
            for i in range(200)]
    arrivals = [(i * 1e-6, app, 1e-4) for i, app in enumerate(apps)]
    replay = (jax_replay if pkg is JAX else torch_replay)
    stats = replay(cluster, arrivals)
    assert (stats["placed"], stats["finished"], stats["still_pending"]) == \
        (200, 200, 0)
    return ({k: v for k, v in stats.items()
             if k not in ("wall_s", "sched_ops_per_s")}, cluster.capacity(),
            [j.job_id for j in cluster.scheduler.completed])


def test_trace_replay_matches_reference():
    _both(_trace_replay)
    stats = torch_throughput(n_jobs=2000, num_pods=8)
    assert stats["placed"] == stats["finished"] == 2000


def test_serve_steps_match_reference(params):
    """``serving/serve_step.py``: reduced tinyllama-1.1b's prefill step and
    four greedy decode steps over a batch of two prompts give the
    reference's tokens (under the ``TIE_GAP`` rule) from its weights."""
    import jax.numpy as jnp
    from repro.core.materializer import SINGLE_POD, materialize
    from repro.serving import serve_step as jax_steps
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.core.materializer import H100
    from repro_torch.core.materializer import materialize as t_materialize
    from repro_torch.models.model import Model
    from repro_torch.runtime.application import REDUCED_SHAPES
    from repro_torch.serving import serve_step

    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    cfg = reduced_config(get_config("tinyllama-1.1b"))
    shape = REDUCED_SHAPES["decode"]
    jmodel = build_model(jcfg, jax_steps.impl_from_plan(
        materialize(jcfg, shape, SINGLE_POD)))
    impl = serve_step.impl_from_plan(t_materialize(cfg, shape, H100))
    assert impl.remat == "none"
    model = Model(cfg, impl)
    weights = params_from_jax(params["tinyllama-1.1b"], cfg, "cpu")
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 40))

    jlogits, jcache = jax_steps.make_prefill_step(jmodel, 64)(
        params["tinyllama-1.1b"], {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, cache = serve_step.make_prefill_step(model, 64)(
        weights, torch.from_numpy(toks))
    jdecode = jax_steps.make_decode_step(jmodel)
    decode = serve_step.make_decode_step(model)
    jnxt = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    want = {0: [int(jnxt[0, 0])], 1: [int(jnxt[1, 0])]}
    got = {0: [int(nxt[0, 0])], 1: [int(nxt[1, 0])]}
    gaps = {i: [float(g)] for i, g in enumerate(
        logits[:, -1].topk(2, -1).values.diff(dim=-1).abs()[:, 0])}
    for pos in range(40, 44):
        jnxt, _, jcache = jdecode(params["tinyllama-1.1b"], jnxt, jcache,
                                  jnp.asarray(pos, jnp.int32))
        nxt, logits, cache = decode(weights, nxt.long(), cache, pos)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        top = logits[:, -1].topk(2, -1).values
        for i in range(2):
            want[i].append(int(jnxt[i, 0]))
            got[i].append(int(nxt[i, 0]))
            gaps[i].append(float(top[i, 0] - top[i, 1]))
    _check_tokens(want, got, gaps)
