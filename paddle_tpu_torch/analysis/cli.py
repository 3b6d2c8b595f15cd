"""tpu-lint command line: `python -m paddle_tpu_torch.analysis <paths>`.

Counterpart of `paddle_tpu/analysis/cli.py`, with its flags.

Text output is one `path:line:col: severity: message [rule]` line per
finding plus a summary; `--json` emits a machine-readable document for CI.
Exit codes: 0 = clean (below --fail-on), 1 = findings at/above --fail-on,
2 = usage error (missing path).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .base import RULES, Finding, severity_at_least
from .lint import lint_paths

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="tpu-lint: static trace-safety analysis for "
                    "paddle_tpu_torch code (host syncs, tensor branches, "
                    "stdlib RNG, retrace forks, lock order) — see README "
                    "'Static analysis'")
    p.add_argument("paths", nargs="+",
                   help="files or directories to lint (dirs recurse)")
    p.add_argument("--all", action="store_true", dest="all_functions",
                   help="scan every function with the syntactic rules, not "
                        "just trace-destined ones (forward/@to_static)")
    p.add_argument("--entry", action="append", default=[],
                   help="extra function NAME treated as trace-destined "
                        "(repeatable)")
    p.add_argument("--no-concurrency", action="store_true",
                   help="skip level 4 (lock-order / blocking-under-lock / "
                        "unregistered-thread); by default the concurrency "
                        "pass runs over the same paths")
    p.add_argument("--rules", default="",
                   help="comma-separated rule ids: report only these")
    p.add_argument("--disable", default="",
                   help="comma-separated rule ids to skip")
    p.add_argument("--fail-on", default="error",
                   choices=["info", "warning", "error", "never"],
                   help="exit 1 when a finding at/above this severity "
                        "exists (default: error)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON on stdout")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _filter(findings: List[Finding], only: str, disable: str
            ) -> List[Finding]:
    keep = {r.strip() for r in only.split(",") if r.strip()}
    drop = {r.strip() for r in disable.split(",") if r.strip()}
    out = findings
    if keep:
        out = [f for f in out if f.rule in keep]
    if drop:
        out = [f for f in out if f.rule not in drop]
    return out


def main(argv: Optional[List[str]] = None,
         stdout=None) -> int:
    out = stdout or sys.stdout
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.id:<18} {r.severity:<8} {r.doc}", file=out)
        return 0

    try:
        findings, n_files = lint_paths(args.paths,
                                       all_functions=args.all_functions,
                                       entries=args.entry)
        if not args.no_concurrency:
            from .concurrency import analyze_paths
            findings += analyze_paths(args.paths)[0]
    except FileNotFoundError as e:
        print(f"tpu-lint: no such path: {e.args[0]}", file=sys.stderr)
        return 2

    findings = _filter(findings, args.rules, args.disable)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    counts = {"error": 0, "warning": 0, "info": 0}
    for f in findings:
        counts[f.severity] += 1

    if args.as_json:
        json.dump({"version": 1, "files": n_files,
                   "counts": counts,
                   "findings": [f.as_dict() for f in findings]},
                  out, indent=1)
        out.write("\n")
    else:
        for f in findings:
            print(f.format(), file=out)
        print(f"tpu-lint: {len(findings)} finding(s) "
              f"({counts['error']} error, {counts['warning']} warning, "
              f"{counts['info']} info) in {n_files} file(s)", file=out)

    if args.fail_on != "never" and any(
            severity_at_least(f.severity, args.fail_on) for f in findings):
        return 1
    return 0
