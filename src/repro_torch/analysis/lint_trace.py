"""CLI for the offline trace linter (a copy of ``repro.analysis.lint_trace``).

    python -m repro_torch.analysis.lint_trace trace.json [trace2.json ...]
        [--json] [--starvation-bound SECS] [--rules r1,r2,...]

Exit status 0 when every trace is clean, 1 when any finding fires, 2 on
load errors (unreadable file / unsupported schema version).  ``--json``
emits one machine-readable object per trace for CI artifact tooling.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.trace import ScheduleTrace, TraceVersionError
from repro_torch.analysis.trace_lint import ALL_RULES, lint_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint_trace",
        description="Lint captured ScheduleTrace JSON files (schema v1-v5).")
    ap.add_argument("traces", nargs="+", help="trace JSON file(s)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON (one object per trace)")
    ap.add_argument("--starvation-bound", type=float, default=None,
                    metavar="SECS",
                    help="no-progress bound for the starvation rule "
                         "(default: half the trace span)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of: " + ", ".join(ALL_RULES))
    args = ap.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        bad = set(rules) - set(ALL_RULES)
        if bad:
            ap.error(f"unknown rules: {sorted(bad)}")

    status = 0
    for path in args.traces:
        try:
            with open(path) as f:
                d = json.load(f)
            trace = ScheduleTrace.from_dict(d)
        except (OSError, ValueError, KeyError, TraceVersionError) as exc:
            print(f"{path}: failed to load: {exc}", file=sys.stderr)
            status = max(status, 2)
            continue
        findings = lint_trace(trace, raw_version=d.get("version"),
                              starvation_bound=args.starvation_bound,
                              rules=rules)
        if args.as_json:
            print(json.dumps({
                "trace": path,
                "version": d.get("version"),
                "events": len(trace.events),
                "findings": [{"rule": f.rule, "message": f.message,
                              "event_index": f.event_index, "t": f.t}
                             for f in findings],
            }))
        elif findings:
            print(f"{path}: {len(findings)} finding(s)")
            for f in findings:
                print(f"  {f}")
        else:
            print(f"{path}: clean ({len(trace.events)} events, "
                  f"schema v{d.get('version')})")
        if findings:
            status = max(status, 1)
    return status


if __name__ == "__main__":
    sys.exit(main())
