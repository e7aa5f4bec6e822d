"""The port's trace exporters, trace summarizer and ``/metrics`` listener
against the JAX package's, on CPU.

The reference's cases of ``tests/test_obs.py`` (the park, unpark and
autoscale events of one episode, both export formats round-tripping
through the loader, the Chrome trace's shape, the ``python -m ...obs``
summary, sparse traces) and all of ``tests/test_metrics_http.py``, each
run through both packages' ``obs`` on the same traffic: the events'
categories, names, scopes and clock-free arguments, the loaded
lifecycles and the summaries' clock-free lines are EQUAL, and the
scraped exposition of one registry is the same text.  The modules are
stdlib only; the port's import nothing of the reference.
"""

import json
import re
import subprocess
import sys
import types
import urllib.error
import urllib.request

import pytest

from repro import obs as jax_obs
from repro.core.history import HistoryStore as JaxHistory
from repro.obs import summary as jax_summary
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.runtime import Application as JaxApp
from repro.runtime import Cluster as JaxCluster
from repro.runtime import NullExecutor as JaxNull
from repro.runtime import ServeOptions as JaxOpts
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro_torch import obs
from repro_torch.core.history import HistoryStore
from repro_torch.obs import summary
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import (Application, Cluster, NullExecutor,
                                 ServeOptions)
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import kv_cache as torch_kv

PAGE = torch_kv.PAGE_SIZE

JAX = types.SimpleNamespace(
    obs=jax_obs, summary=jax_summary, Cluster=JaxCluster, App=JaxApp,
    Opts=JaxOpts, Null=JaxNull, History=JaxHistory,
    Request=jax_kv.Request, PagePool=jax_kv.PagePool,
    Engine=jax_engine.ServingEngine, module="repro.obs")
PORT = types.SimpleNamespace(
    obs=obs, summary=summary, Cluster=Cluster, App=Application,
    Opts=ServeOptions, Null=NullExecutor, History=HistoryStore,
    Request=torch_kv.Request, PagePool=torch_kv.PagePool,
    Engine=torch_engine.ServingEngine, module="repro_torch.obs")


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both planes disabled (the module
    globals are process-wide)."""
    for pkg in (JAX, PORT):
        pkg.obs.disable()
        pkg.obs.disable_metrics()
    yield
    for pkg in (JAX, PORT):
        pkg.obs.disable()
        pkg.obs.disable_metrics()


def _clock_free(args):
    """An event's arguments without the ones read off a clock."""
    return {k: v for k, v in (args or {}).items()
            if not (k.endswith("_s") or k.startswith("rate_"))}


def _events(tracer):
    return [(e[3], e[4], e[5], _clock_free(e[6])) for e in tracer.snapshot()]


# ---------------------------------------------------------------------------
# one park episode's events (tests/test_obs.py:200)
# ---------------------------------------------------------------------------

def _park_episode(pkg):
    t = pkg.obs.enable()
    cluster = pkg.Cluster(pods=1, history=pkg.History(),
                          executor=pkg.Null(), pool_pages=32)
    cluster.enable_autoscale(idle_park_s=2.0, confirm_ticks=1)
    h = cluster.submit(pkg.App.serve(
        "tinyllama-1.1b", reduced=True, name="obs-park",
        serve=pkg.Opts(max_batch=4)))
    # a direct park with a request mid-flight: the drain must show
    h.submit_request(pkg.Request("r0", PAGE - 4, 300))
    for _ in range(3):
        h.step()
    h.park()
    (park,) = t.by_name("park", "autoscale")
    assert park[5] == "obs-park" and park[6]["drained_requests"] == 1
    assert [e[5] for e in t.by_name("park", "request")] == ["r0"]
    h.unpark()
    (unpark,) = t.by_name("unpark", "autoscale")
    assert unpark[5] == "obs-park" and unpark[6]["restored_requests"] == 1
    (rup,) = t.by_name("unpark", "request")
    assert rup[5] == "r0" and rup[6]["restored"] is True
    assert t.by_name("job_park", "scheduler")
    assert t.by_name("job_unpark", "scheduler")
    h.run(max_steps=50_000)
    # the controller's park after sustained idleness explains itself:
    # the rule that fired and the windowed rates it saw
    tick = 0.0
    while not h.parked and tick < 20.0:
        cluster.tick(now=tick)
        tick += 1.0
    assert h.parked
    (dec,) = [e for e in t.by_name("decision", "autoscale")
              if e[6]["action"] == "park"]
    assert dec[5] == "obs-park" and "reason" in dec[6]
    assert any(k.startswith("rate_") for k in dec[6])
    h.submit_request(pkg.Request("r1", 32, 4))   # transparent unpark
    assert not h.parked
    h.run(max_steps=50_000)
    h.release()
    assert t.by_name("job_finish", "scheduler")
    return _events(t)


def test_park_unpark_and_autoscale_events_match_reference():
    want, got = _park_episode(JAX), _park_episode(PORT)
    assert got == want


# ---------------------------------------------------------------------------
# exporters and the summarizer (tests/test_obs.py:257-329)
# ---------------------------------------------------------------------------

def _drive(pkg, n=6, prompt=48, gen=8, max_batch=4):
    """A small null-backend engine run; returns the engine."""
    eng = pkg.Engine(pkg.PagePool(64), max_batch=max_batch)
    for i in range(n):
        eng.submit(pkg.Request(f"r{i}", prompt, gen))
    steps = 0
    while eng.step() and steps < 50_000:
        steps += 1
    return eng


def _traced_run(pkg, tmp_path, fmt):
    t = pkg.obs.enable()
    eng = _drive(pkg, n=4)
    path = str(tmp_path / f"{pkg.module}.{fmt}")
    n = (pkg.obs.write_jsonl(t, path) if fmt == "jsonl"
         else pkg.obs.write_chrome_trace(t, path, extra_meta={"k": "v"}))
    pkg.obs.disable()
    return t, eng, path, n


def _lifecycles(pkg, events):
    return {rid: {k: v for k, v in r.items()
                  if k in ("req", "chunks", "tokens", "preempts", "parks",
                           "unparks", "rejected")}
            | {"names": [e["name"] for e in r["events"]]}
            for rid, r in pkg.summary.request_lifecycles(events).items()}


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
def test_export_roundtrip_matches_reference(tmp_path, fmt):
    out = []
    for pkg in (JAX, PORT):
        t, eng, path, n = _traced_run(pkg, tmp_path, fmt)
        assert n == len(t)
        events = pkg.obs.load_events(path)
        assert len(events) == len(t), "the loader drops metadata rows only"
        reqs = pkg.summary.request_lifecycles(events)
        assert len(reqs) == 4
        for r in reqs.values():
            assert r["submit"] is not None and r["finish"] is not None
            assert r["finish"] >= r["submit"] >= 0.0
            assert r["ttft"] is not None and r["tokens"] == 8
        prefills = [e for e in events if e["name"] == "prefill"]
        assert len(prefills) == eng.stats.prefills
        assert all(0.0 <= e["dur"] < 60.0 for e in prefills)
        assert all(e["args"]["prompt_len"] == 48 for e in prefills)
        out.append((_lifecycles(pkg, events),
                    [(e["cat"], e["name"], e["scope"],
                      _clock_free(e["args"])) for e in events]))
    assert out[1] == out[0]


def _chrome_shape(pkg, tmp_path):
    _, _, path, _ = _traced_run(pkg, tmp_path, "json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["otherData"]["dropped_events"] == 0
    assert doc["otherData"]["k"] == "v"
    evs = doc["traceEvents"]
    procs = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    lanes = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"request", "engine", "pool"} <= procs
    assert {"r0", "r1", "r2", "r3"} <= lanes
    assert all(e["ts"] >= 0.0 for e in evs if e["ph"] != "M")
    return procs, lanes, sorted((e["ph"], e["pid"], e["name"]) for e in evs)


def test_chrome_trace_shape_matches_reference(tmp_path):
    assert _chrome_shape(PORT, tmp_path) == _chrome_shape(JAX, tmp_path)


def _summary_lines(out):
    """The summary's lines with every decimal (a time or a rate) masked,
    its exponent too (a time under 1e-4 s prints as ``1.23e-05``)."""
    return [re.sub(r"\d+\.\d+(?:e[-+]\d+)?", "#", line)
            for line in out.splitlines()]


def test_cli_summary_matches_reference(tmp_path):
    outs = []
    for pkg in (JAX, PORT):
        _, eng, path, _ = _traced_run(pkg, tmp_path, "json")
        out = subprocess.run([sys.executable, "-m", pkg.module, path],
                             capture_output=True, text=True,
                             check=True).stdout
        assert "== trace summary ==" in out
        assert f"decode steps: {eng.stats.decode_steps}" in out
        assert "p50=" in out and "p95=" in out and "p99=" in out
        assert "ttft" in out and "queue_wait" in out
        assert "== slowest request" in out
        assert all(f"r{i} " in out for i in range(4))
        outs.append(_summary_lines(out))
    assert outs[1] == outs[0]


def test_summarize_handles_sparse_traces():
    only_pool = [{"ts": 0.0, "dur": 0.0, "ph": "i", "cat": "pool",
                  "name": "grant", "scope": "a", "args": {"pages": 1}}]
    for events, needle in (([], "requests: 0"), (only_pool, "pool=1")):
        got = summary.summarize(events)
        assert needle in got and got == jax_summary.summarize(events)
    assert summary.pctl([], 99) == 0.0 and summary.pctl([3.0], 50) == 3.0


# ---------------------------------------------------------------------------
# the /metrics listener (tests/test_metrics_http.py)
# ---------------------------------------------------------------------------

def _get(port, path="/metrics"):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, resp.read().decode("utf-8")


@pytest.fixture
def srv():
    s = obs.serve_metrics(port=0)       # an ephemeral port
    yield s
    s.stop()


def _scraped(pkg):
    """The exposition a scrape returns after a small served run."""
    pkg.obs.enable_metrics()
    s = pkg.obs.serve_metrics(port=0)
    try:
        cluster = pkg.Cluster(pods=1, history=pkg.History(),
                              executor=pkg.Null(), pool_pages=16)
        h = cluster.submit(pkg.App.serve(
            "tinyllama-1.1b", reduced=True, name="scrape",
            serve=pkg.Opts(max_batch=2)))
        for i in range(3):
            h.submit_request(pkg.Request(f"m{i}", PAGE - 4, 4))
        h.run(max_steps=200)
        status, body = _get(s.port)
        assert status == 200
        assert "repro_" in body and "# TYPE" in body
        h.release()
        # "/" is an alias; query strings are ignored
        assert _get(s.port, "/")[0] == 200
        assert _get(s.port, "/metrics?x=1")[0] == 200
    finally:
        s.stop()
        pkg.obs.disable_metrics()
    return [line for line in body.splitlines()
            if not line.startswith(("repro_ttft", "repro_decode",
                                    "repro_queue", "repro_e2e"))]


def test_scrape_serves_live_registry():
    """The same run scraped from both listeners: the lines that carry no
    latency are the same text."""
    assert _scraped(PORT) == _scraped(JAX)


def test_scrape_before_enable_is_503(srv):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(srv.port)
    assert exc.value.code == 503
    assert b"enable_metrics" in exc.value.read()
    reg = obs.enable_metrics()
    reg.inc("repro_scrapes_total", app="t")
    status, body = _get(srv.port)
    assert status == 200 and "repro_scrapes_total" in body


def test_unknown_path_is_404(srv):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(srv.port, "/health")
    assert exc.value.code == 404


def test_explicit_registry_overrides_global():
    bodies = []
    for pkg, reg in ((JAX, JaxRegistry()), (PORT, MetricsRegistry())):
        reg.inc("repro_private_total")
        reg.histogram("repro_ttft_seconds", app="x").observe(0.25)
        s = pkg.obs.serve_metrics(port=0, registry=reg)
        try:
            status, body = _get(s.port)
        finally:
            s.stop()
        assert status == 200 and "repro_private_total" in body
        bodies.append(body)
    assert bodies[1] == bodies[0]


def test_stop_closes_listener_and_is_idempotent():
    s = obs.serve_metrics(port=0)
    port = s.port
    s.stop()
    s.stop()                            # a second stop is a no-op
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(port)
