"""Idle-application parking: resource-centric reclamation with warm
restart.  The port's copy of ``repro/autoscale/parking.py``.

The paper's efficiency headline comes from the *platform* reclaiming
resources the application is not using.  For a serve app, "not using"
usually means idle-between-bursts -- yet an idle tenant still pins its KV
pool pages, its device KV arrays, and its scheduler bytes.  Parking
reclaims all three while keeping a warm restart cheap:

1. the engine **drains**: every running request's pages go back to the
   (shared) pool without completing the request;
2. the runner snapshots its weights and *the view's pages* of device KV
   (or its whole dense cache) to **host** in the checkpointer's array
   format (bf16 stored as uint16 + logical dtype, the exact on-disk leaf
   encoding of ``repro_torch.checkpoint``) and drops the device copies;
   the pool-sized page tensors are dropped only when no active co-tenant
   aliases them -- an aliased tenant's reclamation IS its physical pages
   returning to the shared free list for co-tenants to reuse;
3. the **scheduler** releases the job's bytes back to the pod,
   pre-marked as a low-priority reservation (§5.1.1) so unpark usually
   reacquires without re-placement -- and the freed capacity immediately
   drains the pending queue;
4. the app's ``PoolView`` is flagged parked, so it stops diluting
   co-tenants' fair shares.

Unparking is demand-driven -- the next ``submit_request`` (or
``run``) on a parked handle triggers it transparently -- and restores
token-identical decoding: drained requests re-acquire exactly their old
page *count* (fresh ids), the saved KV is scattered into the new pages,
and ``engine.running`` is rebuilt in drain order.  A request whose pages
cannot be re-granted (co-tenants consumed the pool meanwhile), or whose
shared prefix pages were flushed or evicted meanwhile, falls back to the
at-least-once path: re-queued from scratch, still deterministic.

The reference's runtime-sanitizer hooks (``repro_torch.analysis.zensan``:
the quiescent-point checks and the resolution of the park receipts it
keeps per drained request) sit where the reference has them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis import zensan
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.kv_cache import Request


@dataclass
class ParkedRequest:
    """One drained in-flight request: enough to re-grant and restore."""

    req: Request
    num_pages: int                  # growing-table (global-group) pages
    num_local_pages: int = 0        # sliding-window ring pages


@dataclass
class ParkedApp:
    """Everything a parked application needs to resume."""

    requests: List[ParkedRequest] = field(default_factory=list)
    runner_state: Optional[Dict] = None
    freed_bytes: int = 0
    freed_pages: int = 0
    parked_at: float = 0.0


def park_app(handle) -> Dict:
    """Park ``handle`` (a bound, running serve app).  Returns the
    reclamation receipt: freed pool pages, freed scheduler bytes, and the
    number of in-flight requests drained."""
    if handle.app.kind != "serve":
        raise ValueError(f"{handle.app.name}: only serve applications "
                         "park (a train app checkpoints and releases)")
    if handle.parked:
        raise RuntimeError(f"{handle.app.name}: already parked")
    eng = handle.engine
    if eng is None or handle.state != "running":
        raise RuntimeError(f"{handle.app.name}: park needs a bound, "
                           f"running application (state={handle.state})")
    migrated = None
    rset = handle.exec_state.get("replicas")
    if rset is not None and len(rset.replicas) > 1:
        # park IS scale-to-zero: fold the extra replicas into the primary
        # first (token-identical migration), then drain the primary below
        migrated = rset.scale_to(1)
    drained = eng.drain()
    runner = handle.runner
    runner_state = runner.park(drained) if runner is not None else None
    if runner is not None and "params" in handle.exec_state:
        # exec_state aliases the runner's params; a stale reference here
        # would keep the offloaded device tree alive
        handle.exec_state["params"] = None
    view = eng.pool
    if hasattr(view, "parked"):
        view.parked = True
    freed_pages = sum(len(g) + len(l) for _, (g, l) in drained)
    freed_bytes = handle.cluster.scheduler.park(handle.job)
    handle.exec_state["parked"] = ParkedApp(
        requests=[ParkedRequest(req, len(g), len(l))
                  for req, (g, l) in drained],
        runner_state=runner_state, freed_bytes=freed_bytes,
        freed_pages=freed_pages, parked_at=time.monotonic())
    receipt = {"freed_bytes": freed_bytes, "freed_pages": freed_pages,
               "drained_requests": len(drained),
               "kv_arrays_dropped": bool((runner_state or {}).get(
                   "arrays_dropped", runner_state is not None))}
    if migrated is not None:
        receipt["migrated_requests"] = migrated.get("migrated_requests", 0)
    s = zensan.SAN
    if s is not None:
        # quiescent point: every drained page must be back on the free
        # list, with one outstanding park receipt per drained request
        s.check(eng.pool)
    t = obs_trace.TRACER
    if t is not None:
        t.instant("autoscale", "park", handle.app.name, dict(receipt))
        for req, _ in drained:
            t.instant("request", "park", req.req_id,
                      {"app": handle.app.name})
    return receipt


def unpark_app(handle) -> Dict:
    """Resume a parked app: reacquire scheduler bytes, re-grant pages,
    scatter the saved KV back, rebuild ``engine.running`` in drain
    order.  Raises when the pod can no longer fit the app (its parked
    reservation was low-priority and other work took the space)."""
    parked: Optional[ParkedApp] = handle.exec_state.get("parked")
    if parked is None:
        return {}
    eng = handle.engine
    sched = handle.cluster.scheduler
    if parked.freed_bytes and not sched.unpark(handle.job,
                                               parked.freed_bytes):
        raise RuntimeError(
            f"{handle.app.name}: cannot unpark -- the pod no longer has "
            f"{parked.freed_bytes} free bytes (the parked reservation is "
            "low-priority; release other work or wait)")
    view = eng.pool
    if hasattr(view, "parked"):
        view.parked = False
    restored: List[ParkedRequest] = []
    requeued: List[ParkedRequest] = []
    runner = handle.runner
    reattach = getattr(runner, "prefix_reattach", None)
    for pr in parked.requests:
        # the park snapshot holds only PRIVATE pages; a request that was
        # decoding through shared prefix pages must re-pin the same token
        # chain first (the cache may have evicted it while parked --
        # then the snapshot is a torso without its head, so recompute)
        if reattach is not None and not reattach(pr.req):
            eng.pool.prefix_detach(pr.req)
            requeued.append(pr)
            continue
        ok = eng.pool.regrant(pr.req, pr.num_pages, pr.num_local_pages)
        while not ok:
            if not eng._reclaim():
                break
            ok = eng.pool.regrant(pr.req, pr.num_pages, pr.num_local_pages)
        if not ok:
            eng.pool.prefix_detach(pr.req)
        (restored if ok else requeued).append(pr)
    if runner is not None:
        runner.unpark(parked.runner_state, [pr.req for pr in restored])
        if "params" in handle.exec_state:
            handle.exec_state["params"] = runner.params
    eng.running.extend(pr.req for pr in restored)
    s = zensan.SAN
    for pr in requeued:          # at-least-once fallback: re-execute
        pr.req.generated = 0
        pr.req.state = "queued"
        eng.queue.appendleft(pr.req)
        eng.stats.preempted += 1
        if s is not None:
            # the requeued request re-enters from scratch: its park
            # receipt is resolved (nothing left to regrant), not stranded
            s.park_cancel(eng.pool, pr.req.req_id)
    if s is not None:
        s.unpark_done(eng.pool, getattr(eng.pool, "app", handle.app.name))
        s.check(eng.pool)
    del handle.exec_state["parked"]
    receipt = {"restored_requests": len(restored),
               "requeued_requests": len(requeued),
               "reacquired_bytes": parked.freed_bytes,
               "parked_s": time.monotonic() - parked.parked_at}
    t = obs_trace.TRACER
    if t is not None:
        t.instant("autoscale", "unpark", handle.app.name, dict(receipt))
        for pr in restored:
            t.instant("request", "unpark", pr.req.req_id,
                      {"app": handle.app.name, "restored": True})
        for pr in requeued:
            t.instant("request", "unpark", pr.req.req_id,
                      {"app": handle.app.name, "restored": False})
    return receipt
