"""``python -m repro_torch.analysis [paths ...]`` — run reprolint.

Exit status: 0 when clean, 1 when any finding survives suppression,
2 on usage errors. ``--format json`` emits a machine-readable report
(CI uploads it as an artifact); ``--output`` writes the report to a
file while the human summary still goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis.linter import iter_python_files, lint_paths
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: determinism/invariant static analysis "
                    "(rules R001-R006, DESIGN.md §14)")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to lint (default: src)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("--format", choices=("human", "json"),
                    default="human")
    ap.add_argument("--output", default=None,
                    help="write the report to this file as well")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.id}  {r.title}")
        return 0

    rules = list(ALL_RULES)
    if args.rules:
        ids = [s.strip() for s in args.rules.split(",") if s.strip()]
        unknown = [i for i in ids if i not in RULES_BY_ID]
        if unknown:
            print(f"unknown rule ids: {unknown} "
                  f"(known: {sorted(RULES_BY_ID)})", file=sys.stderr)
            return 2
        rules = [RULES_BY_ID[i] for i in ids]

    paths = [Path(p) for p in (args.paths or ["src"])]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"no such path: {missing}", file=sys.stderr)
        return 2
    findings = lint_paths(paths, rules)
    n_files = sum(1 for _ in iter_python_files(paths))

    counts = Counter(f.rule for f in findings)
    report = {"files": n_files,
              "rules": [r.id for r in rules],
              "counts": dict(sorted(counts.items())),
              "findings": [f.as_dict() for f in findings]}
    rendered_json = json.dumps(report, indent=2)

    if args.format == "json":
        print(rendered_json)
    else:
        for f in findings:
            print(f.human())
        tally = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        print(f"reprolint: {len(findings)} finding(s) in {n_files} "
              f"file(s)" + (f" [{tally}]" if tally else ""))
    if args.output:
        Path(args.output).write_text(rendered_json + "\n",
                                     encoding="utf-8")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
