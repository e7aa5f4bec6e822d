"""CLI: ``python -m repro_torch.analysis <paths...>`` (the port's copy of
``repro/analysis/__main__.py``).

Exit status 1 on any unsuppressed finding (the CI zenlint gate), 0 on a
clean tree.  Suppressed findings are listed (with their justification)
when ``--show-suppressed`` is given and always counted in the per-rule
summary, so the job log records how many invariant exceptions the tree
carries and why.

``--format`` selects the output encoding without touching the exit
codes: ``text`` (default, human-readable + per-rule summary), ``json``
(one machine-readable document for dashboards/diffing), ``github``
(workflow-command annotations -- ``::error`` per open finding,
``::notice`` per suppressed one -- so findings surface inline on the
PR diff).  ``--strict-suppressions`` additionally fails the gate on
stale directives that no longer suppress anything.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.analysis.engine import (ENGINE_RULE, Finding, analyze_paths,
                                   default_rules)


def summarize(findings: List[Finding]) -> str:
    rules = {r.rule_id: r.title for r in default_rules()}
    rules[ENGINE_RULE] = "analyzer diagnostics (unsuppressable)"
    lines = [f"{'rule':<7} {'open':>5} {'suppressed':>11}  invariant"]
    for rid in sorted(rules):
        open_n = sum(1 for f in findings
                     if f.rule == rid and not f.suppressed)
        sup_n = sum(1 for f in findings if f.rule == rid and f.suppressed)
        lines.append(f"{rid:<7} {open_n:>5} {sup_n:>11}  {rules[rid]}")
    return "\n".join(lines)


def render_json(findings: List[Finding]) -> str:
    open_n = sum(1 for f in findings if not f.suppressed)
    doc = {
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message, "suppressed": f.suppressed,
             "reason": f.reason}
            for f in findings
        ],
        "open": open_n,
        "suppressed": len(findings) - open_n,
        "ok": open_n == 0,
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def _gh_escape(text: str) -> str:
    """GitHub workflow-command data escaping (the documented set)."""
    return (text.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def render_github(findings: List[Finding],
                  show_suppressed: bool) -> List[str]:
    lines = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        level = "notice" if f.suppressed else "error"
        msg = f.message if not f.suppressed else (
            f"{f.message} [suppressed: {f.reason}]")
        lines.append(f"::{level} file={f.path},line={f.line},"
                     f"title=zenlint {f.rule}::{_gh_escape(msg)}")
    return lines


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="zenlint: AST invariant analysis (page-id provenance, "
                    "stale aliases of rebound device state, compile/"
                    "capture keys, host-sync-free hot paths, "
                    "pool-accounting pairing)")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to analyze")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="ZL00x",
                    help="run only these rule ids (repeatable)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings with reasons")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="output encoding (exit codes are identical): "
                         "human text, one JSON document, or GitHub "
                         "workflow-command annotations")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="also fail on stale directives that no longer "
                         "suppress any finding")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.rule_id}  {r.title}")
        return 0
    if args.rule:
        wanted = {r.upper() for r in args.rule}
        rules = [r for r in rules if r.rule_id in wanted]
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    findings = analyze_paths(args.paths, rules,
                             strict_suppressions=args.strict_suppressions)
    open_findings = [f for f in findings if not f.suppressed]
    if args.format == "json":
        print(render_json(findings))
    elif args.format == "github":
        for line in render_github(findings, args.show_suppressed):
            print(line)
        print(f"zenlint: {'FAIL' if open_findings else 'OK'} "
              f"({len(open_findings)} open finding(s), "
              f"{len(findings) - len(open_findings)} suppressed)")
    else:
        for f in findings:
            if not f.suppressed or args.show_suppressed:
                print(f.render())
        print()
        print(summarize(findings))
        print(f"\nzenlint: {'FAIL' if open_findings else 'OK'} "
              f"({len(open_findings)} open finding(s), "
              f"{len(findings) - len(open_findings)} suppressed)")
    return 1 if open_findings else 0


if __name__ == "__main__":
    sys.exit(main())
