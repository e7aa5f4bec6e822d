"""Continuous-batching serving engine: the port's copy of
``repro/serving/engine.py``.

Admits requests against the page pool (sizing policy from history), runs
prefill for new requests and batched decode for running ones, grows KV
grants on demand, and preempts under pool pressure (re-queued:
at-least-once re-execution).  On a sliding-window stack the pool grants
each request's ring pages beside its growing table: admission grants the
prompt's, growth tops the ring up to ``ring_pages`` and no further,
release, preemption and ``drain`` return both id spaces.  Model execution is carried by a
``ModelRunner`` (``runner=``) or a raw ``step_fns`` (prefill, decode)
pair, so the control-plane tests can run it with neither.

The tracing and metrics hooks are the reference's (``repro_torch.obs``,
off unless enabled).  Left for later slices: the runtime sanitizer,
cross-app arbitration on a pod-shared pool (``preempt_any``) and
prefix-cache attach.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.history import HistoryStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.kv_cache import PagePool, Request


@dataclass
class EngineStats:
    admitted: int = 0
    completed: int = 0
    rejected: int = 0                  # could never fit the pool cap
    preempted: int = 0
    decode_steps: int = 0
    prefills: int = 0
    tokens_generated: int = 0
    wall_s: float = 0.0
    ttft_s_sum: float = 0.0            # submit -> first token, summed
    ttft_count: int = 0
    decode_s_sum: float = 0.0          # summed decode-step wall time

    # every field except wall_s is a monotonic counter; wall_s is a gauge
    # (overwritten per run_to_completion), so deltas exclude it
    COUNTERS = ("admitted", "completed", "rejected", "preempted",
                "decode_steps", "prefills", "tokens_generated",
                "ttft_s_sum", "ttft_count", "decode_s_sum")

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_s_sum / max(self.ttft_count, 1)

    @property
    def mean_decode_step_s(self) -> float:
        return self.decode_s_sum / max(self.decode_steps, 1)

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["mean_ttft_s"] = self.mean_ttft_s
        d["mean_decode_step_s"] = self.mean_decode_step_s
        return d

    # -- windowed semantics --------------------------------------------------
    def snapshot(self) -> "EngineStats":
        """A marker for later ``delta(since=...)`` calls."""
        return dataclasses.replace(self)

    def delta(self, since: "EngineStats") -> "EngineStats":
        """Counters accumulated SINCE a snapshot: the per-window view
        (mean_ttft_s etc. then reflect only that window)."""
        out = dataclasses.replace(self)
        for f in self.COUNTERS:
            setattr(out, f, getattr(self, f) - getattr(since, f))
        return out

    def reset(self) -> "EngineStats":
        """Zero the counters in place, returning the pre-reset snapshot."""
        snap = self.snapshot()
        for f in self.COUNTERS:
            setattr(self, f, type(getattr(self, f))(0))
        return snap


class ServingEngine:
    def __init__(self, pool: PagePool, max_batch: int = 8,
                 step_fns: Optional[Tuple[Callable, Callable]] = None,
                 history: Optional[HistoryStore] = None,
                 runner=None):
        self.pool = pool
        self.max_batch = max_batch
        self.queue: Deque[Request] = collections.deque()
        self.running: List[Request] = []
        self.stats = EngineStats()
        self.runner = runner
        if runner is not None:
            runner.bind(self)
            step_fns = (runner.prefill, runner.decode)
        self.step_fns = step_fns
        self.history = history
        # observability lane label: the pool's app name (obs is off
        # unless enabled)
        self._obs_app = getattr(pool, "app", None) or "serve"

    def submit(self, req: Request, *,
               submitted_at: Optional[float] = None) -> None:
        # the router stamps arrival time once at the front door and passes
        # it through, so TTFT includes router-queue wait on dispatch
        req.submitted_at = (time.perf_counter() if submitted_at is None
                            else submitted_at)
        self.queue.append(req)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("request", "submit", req.req_id,
                      {"app": self._obs_app, "prompt_len": req.prompt_len,
                       "max_new_tokens": req.max_new_tokens})

    def _admit(self) -> List[Request]:
        admitted = []
        t = obs_trace.TRACER
        m = obs_metrics.METRICS
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue[0]
            if not self.pool.admissible(req):
                # can NEVER complete under the pool cap: rejecting beats
                # an admit/grow-deny/preempt livelock
                self.queue.popleft()
                req.state = "rejected"
                self.stats.rejected += 1
                if t is not None:
                    t.instant("request", "reject", req.req_id,
                              {"cause": "inadmissible",
                               "prompt_len": req.prompt_len})
                continue
            if not self.pool.try_admit(req):
                break
            self.queue.popleft()
            self.running.append(req)
            admitted.append(req)
            self.stats.admitted += 1
            if t is not None or m is not None:
                wait = time.perf_counter() - req.submitted_at
                if t is not None:
                    t.instant("request", "admit", req.req_id,
                              {"queue_wait_s": wait,
                               "prompt_len": req.prompt_len,
                               "batch": len(self.running)})
                if m is not None:
                    m.histogram("repro_queue_wait_seconds",
                                app=self._obs_app).observe(wait)
        return admitted

    def preempt(self, victim: Request) -> None:
        """Release a running request's pages and requeue it for
        re-execution (at-least-once)."""
        self.running.remove(victim)
        self.pool.release(victim)
        victim.state = "queued"
        victim.generated = 0
        self.queue.appendleft(victim)
        self.stats.preempted += 1
        t = obs_trace.TRACER
        if t is not None:
            t.instant("request", "preempt", victim.req_id,
                      {"app": self._obs_app})

    def preempt_newest(self) -> bool:
        """Preempt the request with the least progress; False when there is
        nothing to preempt."""
        if not self.running:
            return False
        self.preempt(min(self.running, key=lambda r: r.generated))
        return True

    def drain(self) -> List[Tuple[Request, Tuple[List[int], List[int]]]]:
        """Reclaim every running request's pages without completing it.
        Returns (request, (global page ids, local ring page ids)) in
        running order; the page *contents* are untouched.  Replica removal
        uses it (``serving/router.py``)."""
        drained = []
        for req in list(self.running):
            drained.append((req, self.pool.reclaim(req)))
        self.running.clear()
        return drained

    def _reclaim(self) -> bool:
        """Free pages under pressure: on a private pool, by preempting
        this engine's own newest request.  (The reference first asks a
        pod-shared pool to arbitrate across apps; queue item A6.)"""
        return self.preempt_newest()

    def step(self) -> bool:
        """One engine iteration.  Returns False when fully drained."""
        t = obs_trace.TRACER
        m = obs_metrics.METRICS
        newly = self._admit()
        if self.step_fns is not None:
            prefill_fn, _ = self.step_fns
            for req in newly:
                tp0 = time.perf_counter() if t is not None else 0.0
                prefill_fn(req)
                self.stats.prefills += 1
                if t is not None:
                    t.span("request", "prefill", tp0, time.perf_counter(),
                           req.req_id, {"prompt_len": req.prompt_len})
        else:
            self.stats.prefills += len(newly)
            if t is not None:
                for req in newly:
                    t.instant("request", "prefill", req.req_id,
                              {"prompt_len": req.prompt_len})
        now = time.perf_counter()
        for req in newly:
            if req.first_token_at is None:   # not a re-admission
                req.first_token_at = now
                ttft = now - req.submitted_at
                self.stats.ttft_s_sum += ttft
                self.stats.ttft_count += 1
                if t is not None:
                    t.instant("request", "first_token", req.req_id,
                              {"ttft_s": ttft})
                if m is not None:
                    m.histogram("repro_ttft_seconds",
                                app=self._obs_app).observe(ttft)

        if not self.running:
            return bool(self.queue)

        # grow before decoding (horizon=1: the next token's write slot must
        # be page-backed); `req in self.running` skips requests preempted
        # earlier in this pass
        for req in list(self.running):
            while req in self.running and not self.pool.grow(req, horizon=1):
                if not self._reclaim():
                    break

        if self.step_fns is not None:
            _, decode_fn = self.step_fns
            t0 = time.perf_counter()
            decode_fn(self.running)
            t1 = time.perf_counter()
            self.stats.decode_s_sum += t1 - t0
            if t is not None:
                t.span("engine", "decode_step", t0, t1, self._obs_app,
                       {"batch": len(self.running),
                        "queue": len(self.queue)})
            if m is not None:
                m.histogram("repro_decode_step_seconds",
                            app=self._obs_app).observe(t1 - t0)
                m.histogram("repro_batch_occupancy",
                            obs_metrics.OCCUPANCY_BOUNDS,
                            app=self._obs_app).observe(len(self.running))
        else:
            if t is not None:
                t.instant("engine", "decode_step", self._obs_app,
                          {"batch": len(self.running),
                           "queue": len(self.queue)})
            if m is not None:
                m.histogram("repro_batch_occupancy",
                            obs_metrics.OCCUPANCY_BOUNDS,
                            app=self._obs_app).observe(len(self.running))
        for req in list(self.running):
            req.generated += 1
            self.stats.tokens_generated += 1
            if req.generated >= req.max_new_tokens:
                self.running.remove(req)
                self.pool.release(req)
                if self.runner is not None:
                    self.runner.finish(req)
                self.stats.completed += 1
                if t is not None:
                    t.instant("request", "finish", req.req_id,
                              {"tokens": req.generated})
        self.stats.decode_steps += 1
        return bool(self.queue or self.running)

    def run_to_completion(self, max_steps: int = 1_000_000) -> EngineStats:
        t0 = time.perf_counter()
        steps = 0
        while self.step():
            steps += 1
            if steps >= max_steps:
                break
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    def shutdown(self) -> None:
        """Release every held page (called on application release)."""
        for req in list(self.running):
            self.pool.release(req)
        self.running.clear()
        self.queue.clear()
