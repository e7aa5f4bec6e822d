"""Event-driven trace replay through the REAL submission path.  The
port's copy of ``repro/runtime/simulate.py``.

The scheduler-scalability benchmark (paper §6.2: 50k invocations/s global,
20k components/s per rack) replays arrival traces through
``Cluster.submit`` / ``AppHandle.release`` with a :class:`NullExecutor` --
the same objects and code path that drive real execution, so the measured
decision throughput is honest about every piece of per-application
bookkeeping the runtime does.
"""

from __future__ import annotations

import heapq
import itertools
import random
import time
from typing import Dict, List, Tuple

from repro_torch.runtime.application import Application
from repro_torch.runtime.cluster import GB, AppHandle, Cluster
from repro_torch.runtime.executors import NullExecutor


def replay_trace(cluster: Cluster,
                 arrivals: List[Tuple[float, Application, float]]) -> Dict:
    """Replay ``(t_arrive, app, duration)`` arrivals.  Returns throughput
    stats.  Applications that queue (insufficient capacity) are completed
    once the scheduler drains them on a later release."""
    seq = itertools.count()
    events: List[Tuple[float, int, str, object]] = []
    for t, app, dur in arrivals:
        heapq.heappush(events, (t, next(seq), "arrive", (app, dur)))
    waiting: List[Tuple[AppHandle, float]] = []
    placed = finished = 0
    wall0 = time.perf_counter()
    while events:
        t, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            app, dur = payload
            handle = cluster.submit(app)
            if handle.state == "running":
                placed += 1
                heapq.heappush(events, (t + dur, next(seq), "finish", handle))
            else:
                waiting.append((handle, dur))
        else:
            payload.release()
            finished += 1
            if waiting:  # queue drained inside release: schedule their ends
                still = []
                for handle, dur in waiting:
                    if handle.state == "running":
                        placed += 1
                        heapq.heappush(events,
                                       (t + dur, next(seq), "finish", handle))
                    else:
                        still.append((handle, dur))
                waiting = still
    wall = time.perf_counter() - wall0
    return {
        "placed": placed, "finished": finished,
        "still_pending": len(waiting),
        "wall_s": wall,
        "sched_ops_per_s": (placed + finished) / max(wall, 1e-9),
    }


def measure_cluster_throughput(n_jobs: int = 50_000,
                               num_pods: int = 8) -> Dict:
    """Pure scheduling decisions/second through the runtime API."""
    rnd = random.Random(0)
    arrivals = []
    for i in range(n_jobs):
        demand = rnd.choice([1, 2, 4, 8, 16]) * GB
        app = Application.synthetic(f"app{i % 32}", "serve", demand)
        arrivals.append((i * 1e-6, app, 1e-3))
    cluster = Cluster(num_pods, executor=NullExecutor())
    return replay_trace(cluster, arrivals)
