"""Offline trace analysis: the ``python -m repro_torch.obs`` summarizer.
The port's copy of ``repro/obs/summary.py``.

Consumes either export format (Chrome trace JSON or JSONL, via
``export.load_events``) and reconstructs the per-request story the ring
buffer captured:

* **lifecycle table** -- per request: submit -> admit (queue wait) ->
  prefill (span + chunk count) -> first token (TTFT) -> finish, with
  preempt/park counts;
* **percentile tables** -- p50/p95/p99 of TTFT, queue wait, decode-step
  latency, and decode batch occupancy;
* **slowest-request drill-down** -- the full ordered event sequence of
  the worst-TTFT request with inter-event deltas (its critical path).

Pure stdlib, pure offline: nothing here is a hot-path API.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def pctl(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile on raw samples (exact, unlike the
    fixed-bucket Histogram approximation)."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(p / 100.0 * len(s) + 0.5)) - 1))
    return s[idx]


def request_lifecycles(events: List[Dict]) -> Dict[str, Dict]:
    """Fold request-cat events into one record per request id."""
    reqs: Dict[str, Dict] = {}

    def rec(scope: str) -> Dict:
        r = reqs.get(scope)
        if r is None:
            r = {"req": scope, "submit": None, "admit": None,
                 "queue_wait": None, "prefill_dur": 0.0, "chunks": 0,
                 "ttft": None, "finish": None, "tokens": None,
                 "preempts": 0, "parks": 0, "unparks": 0,
                 "rejected": False, "events": []}
            reqs[scope] = r
        return r

    for e in sorted(events, key=lambda e: e["ts"]):
        if e["cat"] != "request" or not e.get("scope"):
            continue
        r = rec(e["scope"])
        r["events"].append(e)
        name, args = e["name"], e.get("args") or {}
        if name == "submit":
            r["submit"] = e["ts"]
        elif name == "admit":
            r["admit"] = e["ts"]
            r["queue_wait"] = args.get("queue_wait_s")
        elif name == "reject":
            r["rejected"] = True
        elif name == "prefill":
            r["prefill_dur"] += e.get("dur", 0.0)
        elif name == "prefill_chunk":
            r["chunks"] += 1
        elif name == "first_token":
            r["ttft"] = args.get("ttft_s")
        elif name == "preempt":
            r["preempts"] += 1
        elif name == "park":
            r["parks"] += 1
        elif name == "unpark":
            r["unparks"] += 1
        elif name == "finish":
            r["finish"] = e["ts"]
            r["tokens"] = args.get("tokens")
    return reqs


def decode_steps(events: List[Dict]) -> List[Dict]:
    return [e for e in events
            if e["cat"] == "engine" and e["name"] == "decode_step"]


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v * 1e3:9.3f}" if v is not None else "        -"


def _pct_row(label: str, values: Sequence[float], unit: str = "ms") -> str:
    scale = 1e3 if unit == "ms" else 1.0
    return (f"  {label:<24} n={len(values):<6} "
            f"p50={pctl(values, 50) * scale:9.3f} "
            f"p95={pctl(values, 95) * scale:9.3f} "
            f"p99={pctl(values, 99) * scale:9.3f} {unit}")


def summarize(events: List[Dict]) -> str:
    """The full human-readable report for a trace file."""
    lines: List[str] = []
    reqs = request_lifecycles(events)
    done = [r for r in reqs.values() if not r["rejected"]]
    rejected = [r for r in reqs.values() if r["rejected"]]
    steps = decode_steps(events)

    lines.append("== trace summary ==")
    lines.append(f"  events: {len(events)}   requests: {len(reqs)} "
                 f"({len(rejected)} rejected)   decode steps: {len(steps)}")
    by_cat: Dict[str, int] = {}
    for e in events:
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
    lines.append("  by category: " + "  ".join(
        f"{c}={n}" for c, n in sorted(by_cat.items())))

    # -- percentile tables ---------------------------------------------------
    ttfts = [r["ttft"] for r in done if r["ttft"] is not None]
    waits = [r["queue_wait"] for r in done if r["queue_wait"] is not None]
    step_durs = [e["dur"] for e in steps]
    batches = [float((e.get("args") or {}).get("batch", 0)) for e in steps]
    lines.append("")
    lines.append("== latency percentiles ==")
    lines.append(_pct_row("ttft", ttfts))
    lines.append(_pct_row("queue_wait", waits))
    lines.append(_pct_row("decode_step", step_durs))
    lines.append(_pct_row("batch_occupancy", batches, unit="reqs"))

    # -- per-request lifecycle table -----------------------------------------
    lines.append("")
    lines.append("== requests ==")
    lines.append(f"  {'req':<12} {'queue_ms':>9} {'prefill_ms':>10} "
                 f"{'chunks':>6} {'ttft_ms':>9} {'e2e_ms':>9} "
                 f"{'toks':>5} {'pre':>3} {'park':>4}")
    for r in sorted(done, key=lambda r: r["submit"] or 0.0):
        e2e = (r["finish"] - r["submit"]
               if r["finish"] is not None and r["submit"] is not None
               else None)
        lines.append(
            f"  {r['req']:<12} {_fmt_ms(r['queue_wait'])} "
            f"{r['prefill_dur'] * 1e3:10.3f} {r['chunks']:>6} "
            f"{_fmt_ms(r['ttft'])} {_fmt_ms(e2e)} "
            f"{r['tokens'] if r['tokens'] is not None else '-':>5} "
            f"{r['preempts']:>3} {r['parks']:>4}")

    # -- slowest-request drill-down ------------------------------------------
    with_ttft = [r for r in done if r["ttft"] is not None]
    if with_ttft:
        worst = max(with_ttft, key=lambda r: r["ttft"])
        lines.append("")
        lines.append(f"== slowest request: {worst['req']} "
                     f"(ttft {worst['ttft'] * 1e3:.3f} ms) ==")
        prev = None
        for e in worst["events"]:
            delta = (e["ts"] - prev) * 1e3 if prev is not None else 0.0
            prev = e["ts"]
            args = e.get("args") or {}
            arg_s = " ".join(f"{k}={v}" for k, v in args.items()
                             if k != "scope")
            dur_s = (f" dur={e['dur'] * 1e3:.3f}ms"
                     if e.get("dur") else "")
            lines.append(f"  +{delta:9.3f}ms  {e['name']:<14}{dur_s}"
                         f"  {arg_s}")

    # -- autoscale decisions -------------------------------------------------
    decisions = [e for e in events
                 if e["cat"] == "autoscale" and e["name"] == "decision"]
    if decisions:
        lines.append("")
        lines.append("== autoscale decisions ==")
        for e in decisions:
            args = e.get("args") or {}
            lines.append(f"  t={e['ts']:8.3f}s app={e.get('scope')} "
                         f"{args.get('action', '?'):<10} "
                         f"{args.get('reason', '')}")
    return "\n".join(lines)
