"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and JSONL.
The port's copy of ``repro/obs/export.py``.

Export happens *offline* (end of run, or on demand) -- never on the hot
path.  The in-memory event tuples (see ``repro_torch.obs.trace``) map onto the
Chrome trace-event format:

* ``ph: "i"`` instants and ``ph: "X"`` complete spans,
* ``ts``/``dur`` in microseconds relative to the tracer's ``t0`` (so a
  trace always starts near 0),
* ``pid`` = the subsystem category (one process row per cat in the
  Perfetto UI), ``tid`` = the event's scope (one thread lane per
  request id / app name), with ``M``-phase metadata events naming the
  rows so the UI shows ``request`` / ``pool`` / ``autoscale`` groups
  with per-request lanes inside.

Load the JSON into https://ui.perfetto.dev or ``chrome://tracing``; the
JSONL form is one event-object per line for ad-hoc ``jq``/pandas work
and is what ``python -m repro_torch.obs`` also accepts.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .trace import Event, Tracer

#: stable pid assignment per category so lanes group deterministically
CAT_PIDS = {"request": 1, "engine": 2, "pool": 3, "compile": 4,
            "autoscale": 5, "scheduler": 6}
_OTHER_PID = 99


def _tid_map(events: Iterable[Event]) -> Dict[tuple, int]:
    """Assign a stable tid per (pid, scope), in first-seen order; the
    scope-less engine-wide lane is tid 0."""
    tids: Dict[tuple, int] = {}
    for ev in events:
        pid = CAT_PIDS.get(ev[3], _OTHER_PID)
        key = (pid, ev[5] or "")
        if key not in tids:
            tids[key] = 0 if ev[5] is None else len(tids) + 1
    return tids


def to_chrome_events(tracer: Tracer) -> List[Dict]:
    """The tracer's ring as a list of Chrome trace-event dicts
    (metadata rows first, then events oldest-first)."""
    events = tracer.snapshot()
    tids = _tid_map(events)
    t0 = tracer.t0
    out: List[Dict] = []
    # metadata: name the process rows and thread lanes
    for cat, pid in sorted(CAT_PIDS.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": cat}})
    for (pid, scope), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        if scope:
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": scope}})
    for ts, dur, ph, cat, name, scope, args in events:
        pid = CAT_PIDS.get(cat, _OTHER_PID)
        rec = {"ph": ph, "pid": pid, "tid": tids[(pid, scope or "")],
               "ts": (ts - t0) * 1e6, "cat": cat, "name": name}
        if ph == "X":
            rec["dur"] = dur * 1e6
        if ph == "i":
            rec["s"] = "t"  # thread-scoped instant marker
        if args:
            rec["args"] = dict(args)
        elif scope:
            rec["args"] = {}
        if scope:
            rec.setdefault("args", {})["scope"] = scope
        out.append(rec)
    return out


def write_chrome_trace(tracer: Tracer, path: str,
                       extra_meta: Optional[Dict] = None) -> int:
    """Write the full ``{"traceEvents": [...]}`` JSON object form (the
    one Perfetto/chrome://tracing load directly).  Returns the number of
    trace events written (metadata rows excluded)."""
    events = to_chrome_events(tracer)
    n = sum(1 for e in events if e["ph"] != "M")
    doc = {"traceEvents": events,
           "displayTimeUnit": "ms",
           "otherData": {"dropped_events": tracer.dropped,
                         **(extra_meta or {})}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return n


def write_jsonl(tracer: Tracer, path: str) -> int:
    """One raw event object per line (not Chrome-shaped: keeps the
    native ts/dur seconds and scope field) for jq/pandas pipelines."""
    events = tracer.snapshot()
    t0 = tracer.t0
    with open(path, "w") as f:
        for ts, dur, ph, cat, name, scope, args in events:
            rec = {"ts": ts - t0, "dur": dur, "ph": ph, "cat": cat,
                   "name": name}
            if scope is not None:
                rec["scope"] = scope
            if args:
                rec["args"] = dict(args)
            f.write(json.dumps(rec) + "\n")
    return len(events)


def load_events(path: str) -> List[Dict]:
    """Load either export format back into a flat list of event dicts
    with keys ts (seconds), dur (seconds), ph, cat, name, scope, args.
    Chrome metadata rows are dropped; Chrome us units are converted."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None                       # JSONL: one object per line
    if doc is not None:
        raw = doc["traceEvents"] if isinstance(doc, dict) else doc
        out = []
        for e in raw:
            if e.get("ph") == "M":
                continue
            args = dict(e.get("args") or {})
            scope = args.pop("scope", None)
            out.append({"ts": e.get("ts", 0.0) / 1e6,
                        "dur": e.get("dur", 0.0) / 1e6,
                        "ph": e["ph"], "cat": e.get("cat", ""),
                        "name": e["name"], "scope": scope,
                        "args": args})
        return out
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        e = json.loads(line)
        e.setdefault("dur", 0.0)
        e.setdefault("scope", None)
        e.setdefault("args", {})
        out.append(e)
    return out
