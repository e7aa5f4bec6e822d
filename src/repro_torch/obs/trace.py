"""Request-lifecycle tracing: a bounded ring buffer of typed events.
A copy of ``repro/obs/trace.py``; the port's engine, router and
scheduler emit the same events.

The serving and autoscale planes emit lifetime *aggregates*
(``EngineStats`` sums, ``POOL_COUNTERS``), which answer "how did the run
go" but never "why was THIS request slow".  The :class:`Tracer` is the
missing per-event substrate: every significant moment of a request's
life (submit -> admit -> prefix pin -> prefill chunks -> batched decode
ticks -> preempt/park/unpark -> finish/reject), every pool arbitration
(grant / denial / eviction / cache donation), every scheduler
decision (admit / pending / finish), and every replica change lands
here as one tuple with a monotonic ``perf_counter`` timestamp.

Overhead discipline on every instrumented hot path:

* **off by default** -- the module global :data:`TRACER` is ``None``;
  every instrumentation site is ``t = trace.TRACER`` + ``if t is not
  None`` + one method call, so the disabled cost is one module
  attribute read and a ``None`` check (no string formatting, no dict
  building, no timestamps);
* **guard-and-append only when enabled** -- an event is one tuple
  appended to a ``deque(maxlen=capacity)``; no I/O, no formatting, no
  host syncs on device values (event args must already be host
  scalars);
* **bounded** -- the ring drops the OLDEST events when full and counts
  the drops (``tracer.dropped``), so a week-long serving process can
  leave tracing on.

Event model (Chrome ``trace_event``-shaped; the reference's
``repro/obs/export.py`` writes it out and is not ported yet):

``(ts, dur, ph, cat, name, scope, args)`` where ``ph`` is ``"i"``
(instant) or ``"X"`` (complete span, ``dur`` seconds), ``cat`` is the
subsystem (``request`` / ``engine`` / ``pool`` / ``compile`` /
``autoscale`` / ``scheduler``), ``scope`` groups events onto one
timeline lane (a request id, an app name, or None for the engine-wide
lane), and ``args`` is a small dict of host scalars (or None).

Timebase: ``time.perf_counter()`` everywhere -- the same clock the
engine stamps ``Request.submitted_at`` with, so trace timestamps and
engine latencies compose exactly (``runtime.cluster`` times train
steps on it too).
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional, Tuple

#: one trace event: (ts_s, dur_s, ph, cat, name, scope, args)
Event = Tuple[float, float, str, str, str, Optional[str], Optional[Dict]]

#: the process-wide tracer; None = tracing disabled (the default).
#: Instrumentation sites read this module attribute directly::
#:
#:     t = trace.TRACER
#:     if t is not None:
#:         t.instant("request", "submit", req.req_id)
TRACER: Optional["Tracer"] = None

DEFAULT_CAPACITY = 1 << 16


class Tracer:
    """Bounded ring buffer of typed trace events (monotonic timestamps)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: Deque[Event] = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.t0 = time.perf_counter()

    # -- emission (the hot-path API: guard-and-append only) ------------------
    def instant(self, cat: str, name: str, scope: Optional[str] = None,
                args: Optional[Dict] = None) -> None:
        """One zero-duration event at now."""
        ev = self.events
        if len(ev) == self.capacity:
            self.dropped += 1
        ev.append((time.perf_counter(), 0.0, "i", cat, name, scope, args))

    def span(self, cat: str, name: str, t_start: float, t_end: float,
             scope: Optional[str] = None,
             args: Optional[Dict] = None) -> None:
        """One complete span: the caller measured ``t_start``/``t_end``
        with ``perf_counter`` (no clock read here -- the span must not
        include the tracer's own bookkeeping)."""
        ev = self.events
        if len(ev) == self.capacity:
            self.dropped += 1
        ev.append((t_start, t_end - t_start, "X", cat, name, scope, args))

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def snapshot(self) -> List[Event]:
        """A stable copy of the current ring (oldest first)."""
        return list(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0

    def by_name(self, name: str, cat: Optional[str] = None) -> List[Event]:
        """Events with ``name`` (and ``cat`` when given), oldest first --
        the test/CLI convenience accessor, not a hot-path API."""
        return [e for e in self.events
                if e[4] == name and (cat is None or e[3] == cat)]

    def by_scope(self, scope: str) -> List[Event]:
        return [e for e in self.events if e[5] == scope]


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) a fresh process-wide tracer.  Idempotent in
    spirit: a second call replaces the ring (the old events are the
    caller's to keep via ``snapshot()`` first)."""
    global TRACER
    TRACER = Tracer(capacity)
    return TRACER


def disable() -> Optional[Tracer]:
    """Remove the process-wide tracer; returns it (with its events) so a
    caller can still export what was captured."""
    global TRACER
    t, TRACER = TRACER, None
    return t


def current() -> Optional[Tracer]:
    return TRACER
