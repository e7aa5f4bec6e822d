"""Two-level scheduler: global (cross-pod) + pod-level (per-pod).
A copy of ``repro/core/scheduler.py``.

Paper §5.3.1: one global scheduler balances application requests across
racks; each rack-level scheduler places components on servers and keeps an
exact view of per-server free resources.  On accelerators: the global
scheduler balances *jobs* (training runs / serving replicas) across pods;
each pod scheduler places a job's resource-graph components onto devices
via the materializer and tracks HBM/device occupancy.  (The reference's
event-driven trace replay, ``repro/runtime/simulate.py``, drives the same
objects; it is not ported yet.)

Placement policy (§5.1.1): locality-greedy best-fit -- choose the pod with
the *smallest* sufficient free capacity, leaving larger pods free for
future bulky invocations; pre-mark (low-priority reserve) the remaining
profile-estimated demand of a running application.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import ResourceGraph
from repro_torch.core.history import HistoryStore
from repro_torch.core.materializer import Plan
from repro_torch.obs import trace as obs_trace

GB = 1 << 30


@dataclass
class Job:
    job_id: str
    app: str                       # arch name
    kind: str                      # train | serve
    demand_bytes: int              # profile-estimated footprint
    demand_chips: int
    graph: Optional[ResourceGraph] = None
    plan: Optional[Plan] = None
    pod: Optional[str] = None
    state: str = "pending"         # pending | running | done | failed
    peak_bytes: int = 0            # high-water demand (history record)


@dataclass
class PodState:
    name: str
    num_chips: int
    hbm_per_chip: int
    free_bytes: int = 0
    reserved_bytes: int = 0        # low-priority marks (paper §5.1.1)
    running: Dict[str, Job] = field(default_factory=dict)

    def __post_init__(self):
        if self.free_bytes == 0:
            self.free_bytes = self.num_chips * self.hbm_per_chip

    @property
    def available(self) -> int:
        return self.free_bytes

    @property
    def available_unreserved(self) -> int:
        return max(self.free_bytes - self.reserved_bytes, 0)


class PodScheduler:
    """Rack-level analog: places components of one job onto chips."""

    def __init__(self, pod: PodState, history: Optional[HistoryStore] = None):
        self.pod = pod
        self.history = history
        self.placements: Dict[str, Dict[str, str]] = {}

    def admit(self, job: Job) -> bool:
        if job.demand_bytes > self.pod.available:
            return False
        self.pod.free_bytes -= job.demand_bytes
        self.pod.running[job.job_id] = job
        job.pod = self.pod.name
        job.state = "running"
        job.peak_bytes = max(job.peak_bytes, job.demand_bytes)
        if job.graph is not None:
            self.placements[job.job_id] = self._place_components(job)
        return True

    def _place_components(self, job: Job) -> Dict[str, str]:
        """Locality-greedy per-component placement record.

        Components that fit together are 'merged' (one device group); data
        components whose accessors are all co-located are local, others are
        sharded ('remote')."""
        out = {}
        g = job.graph
        for name in g.topo_order():
            out[name] = "merged/local"
        for dname, d in g.data.items():
            accs = set(g.accessors(dname))
            out[dname] = ("local" if len(accs) <= 1 else
                          "shared/sharded")
        return out

    def scale_up(self, job_id: str, extra_bytes: int) -> bool:
        """Runtime component growth (paper §5.1.2 data-component scaling)."""
        job = self.pod.running.get(job_id)
        if job is None or extra_bytes > self.pod.available:
            return False
        self.pod.free_bytes -= extra_bytes
        job.demand_bytes += extra_bytes
        job.peak_bytes = max(job.peak_bytes, job.demand_bytes)
        return True

    def scale_down(self, job_id: str, release_bytes: int) -> int:
        """Shrink a running job, returning bytes actually freed."""
        job = self.pod.running.get(job_id)
        if job is None:
            return 0
        freed = min(release_bytes, job.demand_bytes)
        job.demand_bytes -= freed
        self.pod.free_bytes += freed
        return freed

    def release(self, job_id: str) -> None:
        job = self.pod.running.pop(job_id, None)
        if job is not None:
            self.pod.free_bytes += job.demand_bytes
            job.state = "done"
        self.placements.pop(job_id, None)


class GlobalScheduler:
    """Cluster-level: balance jobs across pods (best-fit smallest pod)."""

    def __init__(self, pods: List[PodState],
                 history: Optional[HistoryStore] = None):
        self.pods = {p.name: PodScheduler(p, history) for p in pods}
        self.history = history
        self.pending: List[Job] = []
        self.completed: List[Job] = []
        self.rejected: List[Job] = []
        # per-job low-priority reservations (pre-marked future demand);
        # released on finish so pods regain available_unreserved capacity
        self.reservations: Dict[str, Tuple[str, int]] = {}

    def submit(self, job: Job) -> Optional[str]:
        """Paper policy: smallest pod with sufficient free resources.

        Pre-marked reservations are low-priority (§5.1.1): admission first
        looks for a pod whose UNRESERVED capacity fits the job, and only
        when none exists takes space out of another job's reserve."""
        cands = [(ps.pod.available_unreserved, name)
                 for name, ps in self.pods.items()
                 if ps.pod.available_unreserved >= job.demand_bytes]
        if not cands:
            cands = [(ps.pod.available, name)
                     for name, ps in self.pods.items()
                     if ps.pod.available >= job.demand_bytes]
        if not cands:
            self.pending.append(job)
            t = obs_trace.TRACER
            if t is not None:
                t.instant("scheduler", "job_pending", job.job_id,
                          {"app": job.app,
                           "demand_bytes": job.demand_bytes})
            return None
        _, name = min(cands)
        ok = self.pods[name].admit(job)
        if not ok:  # raced; retry queue
            self.pending.append(job)
            return None
        t = obs_trace.TRACER
        if t is not None:
            t.instant("scheduler", "job_admit", job.job_id,
                      {"app": job.app, "pod": name,
                       "demand_bytes": job.demand_bytes})
        # pre-mark estimated future demand (low-priority reservation)
        if self.history is not None:
            est_peak = self.history.peak(job.app, "job", "bytes",
                                         job.demand_bytes)
            mark = max(int(est_peak) - job.demand_bytes, 0)
            if mark:
                self.pods[name].pod.reserved_bytes += mark
                self.reservations[job.job_id] = (name, mark)
        return name

    def scale_up(self, job: Job, extra_bytes: int) -> bool:
        """Grow a running job, consuming its pre-marked reservation first."""
        if job.pod is None or not self.pods[job.pod].scale_up(
                job.job_id, extra_bytes):
            return False
        res = self.reservations.get(job.job_id)
        if res is not None:
            name, mark = res
            consumed = min(mark, extra_bytes)
            self.pods[name].pod.reserved_bytes -= consumed
            if mark - consumed > 0:
                self.reservations[job.job_id] = (name, mark - consumed)
            else:
                del self.reservations[job.job_id]
        return True

    def scale_down(self, job: Job, release_bytes: int) -> int:
        if job.pod is None:
            return 0
        return self.pods[job.pod].scale_down(job.job_id, release_bytes)

    # -- idle parking (resource-centric reclamation) -------------------------
    def park(self, job: Job, keep_bytes: int = 0) -> int:
        """Release an idle job's bytes back to its pod, pre-marking them as
        the job's low-priority reservation (§5.1.1): other work may take the
        space, but while it stays free the parked job reacquires it on
        unpark without re-placement.  Freed capacity drains the pending
        queue.  Returns the bytes actually freed."""
        if job.pod is None:
            return 0
        freed = self.scale_down(job, max(job.demand_bytes - keep_bytes, 0))
        if freed:
            pod, mark = self.reservations.get(job.job_id, (job.pod, 0))
            self.pods[pod].pod.reserved_bytes += freed
            self.reservations[job.job_id] = (pod, mark + freed)
            t = obs_trace.TRACER
            if t is not None:
                t.instant("scheduler", "job_park", job.job_id,
                          {"app": job.app, "freed_bytes": freed})
            self._drain_pending()
        return freed

    def unpark(self, job: Job, reacquire_bytes: int) -> bool:
        """Reacquire a parked job's bytes (consumes the park reservation).
        False when co-tenants took the space in the meantime."""
        ok = self.scale_up(job, reacquire_bytes)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("scheduler", "job_unpark", job.job_id,
                      {"app": job.app, "ok": ok,
                       "reacquire_bytes": reacquire_bytes})
        return ok

    def cancel(self, job: Job) -> bool:
        """Drop a still-pending job from the queue."""
        if job in self.pending:
            self.pending.remove(job)
            job.state = "failed"
            self.rejected.append(job)
            return True
        return False

    def _release_reservation(self, job: Job) -> None:
        res = self.reservations.pop(job.job_id, None)
        if res is not None:
            name, mark = res
            self.pods[name].pod.reserved_bytes -= mark

    def finish(self, job: Job) -> None:
        if job.pod:
            self.pods[job.pod].release(job.job_id)
        self._release_reservation(job)
        job.state = "done"
        self.completed.append(job)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("scheduler", "job_finish", job.job_id,
                      {"app": job.app})
        if self.history is not None:
            # record the high-water working footprint, not the residual
            # demand: a parked (or scaled-down) job finishing with ~0
            # bytes would otherwise poison history-driven sizing for the
            # app's next submission
            self.history.observe(job.app, "job", "bytes",
                                 max(job.peak_bytes, job.demand_bytes))
        self._drain_pending()

    def _drain_pending(self) -> None:
        # drain pending queue: iterate a snapshot -- submit() re-appends
        # unplaceable jobs to self.pending, which must not be the list
        # being iterated (it would loop forever on the first failure)
        queued, self.pending = self.pending, []
        for j in queued:
            self.submit(j)
