"""``python -m repro_torch.obs <trace-file>`` -- summarize an exported trace.
The port's copy of ``repro/obs/__main__.py``.

Accepts either export format (Chrome trace JSON from ``--trace`` /
``write_chrome_trace``, or JSONL from ``write_jsonl``) and prints the
per-request lifecycle table, p50/p95/p99 latency tables, and the
slowest-request critical path.  See docs/observability.md.
"""

from __future__ import annotations

import argparse

from .export import load_events
from .summary import summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize a repro_torch.obs trace file "
                    "(Chrome trace JSON or JSONL).")
    ap.add_argument("trace", help="trace file written by --trace or "
                                  "repro_torch.obs.export")
    args = ap.parse_args(argv)
    events = load_events(args.trace)
    try:
        print(summarize(events))
    except BrokenPipeError:        # `... | head` closed the pipe: fine
        return 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
