"""Continuous-batching serving engine: the port's copy of
``repro/serving/engine.py``.

Admits requests against the page pool, runs prefill for new requests and
batched decode for running ones, grows KV grants on demand, and preempts
under pool pressure (re-queued: at-least-once re-execution).  Model
execution is carried by a ``ModelRunner`` (``runner=``) or a raw
``step_fns`` (prefill, decode) pair.

This slice serves one replica on a private pool.  The tracing and
metrics hooks, the runtime sanitizer, cross-app arbitration on a shared
pool, prefix-cache attach and park/drain come with later slices; the
sizing history store too, so ``history`` must be None.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

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


class ServingEngine:
    def __init__(self, pool: PagePool, max_batch: int = 8,
                 step_fns: Optional[Tuple[Callable, Callable]] = None,
                 history=None, runner=None):
        if history is not None:
            raise ValueError("the port's engine has no sizing history store "
                             "yet; pass history=None")
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

    def submit(self, req: Request, *,
               submitted_at: Optional[float] = None) -> None:
        req.submitted_at = (time.perf_counter() if submitted_at is None
                            else submitted_at)
        self.queue.append(req)

    def _admit(self) -> List[Request]:
        admitted = []
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue[0]
            if not self.pool.admissible(req):
                self.queue.popleft()
                req.state = "rejected"
                self.stats.rejected += 1
                continue
            if not self.pool.try_admit(req):
                break
            self.queue.popleft()
            self.running.append(req)
            admitted.append(req)
            self.stats.admitted += 1
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

    def preempt_newest(self) -> bool:
        """Preempt the request with the least progress; False when there is
        nothing to preempt."""
        if not self.running:
            return False
        self.preempt(min(self.running, key=lambda r: r.generated))
        return True

    def step(self) -> bool:
        """One engine iteration.  Returns False when fully drained."""
        newly = self._admit()
        if self.step_fns is not None:
            prefill_fn, _ = self.step_fns
            for req in newly:
                prefill_fn(req)
                self.stats.prefills += 1
        else:
            self.stats.prefills += len(newly)
        now = time.perf_counter()
        for req in newly:
            if req.first_token_at is None:   # not a re-admission
                req.first_token_at = now
                self.stats.ttft_s_sum += now - req.submitted_at
                self.stats.ttft_count += 1

        if not self.running:
            return bool(self.queue)

        # grow before decoding (horizon=1: the next token's write slot must
        # be page-backed); `req in self.running` skips requests preempted
        # earlier in this pass
        for req in list(self.running):
            while req in self.running and not self.pool.grow(req, horizon=1):
                if not self.preempt_newest():
                    break

        if self.step_fns is not None:
            _, decode_fn = self.step_fns
            t0 = time.perf_counter()
            decode_fn(self.running)
            self.stats.decode_s_sum += time.perf_counter() - t0
        for req in list(self.running):
            req.generated += 1
            self.stats.tokens_generated += 1
            if req.generated >= req.max_new_tokens:
                self.running.remove(req)
                self.pool.release(req)
                if self.runner is not None:
                    self.runner.finish(req)
                self.stats.completed += 1
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
        """Release every held page."""
        for req in list(self.running):
            self.pool.release(req)
        self.running.clear()
        self.queue.clear()
