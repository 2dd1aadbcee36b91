"""CLI for s2c2lint: ``python -m repro_torch.analysis [paths...]``.

Exit status: 0 when no non-baselined findings, 1 otherwise, 2 on usage
errors.  ``--write-baseline`` records the current findings as accepted
debt (each entry carries a reason you are expected to edit).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .core import (Baseline, RULE_REGISTRY, load_project, render_json,
                   render_line, run_rules)

DEFAULT_PATHS = ["src/repro_torch/cluster"]
DEFAULT_BASELINE = ".s2c2lint-baseline.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="s2c2lint",
        description="Concurrency-contract and wire-protocol static "
                    "analysis for the S²C² cluster engine.")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/directories to analyze "
                        f"(default: {DEFAULT_PATHS[0]})")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to run "
                        "(default: all)")
    p.add_argument("--json", metavar="FILE", dest="json_out",
                   help="also write a JSON report ('-' for stdout)")
    p.add_argument("--baseline", metavar="FILE",
                   help=f"baseline suppression file (default: "
                        f"{DEFAULT_BASELINE} if it exists)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline file "
                        "and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="list rule ids and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULE_REGISTRY):
            cls = RULE_REGISTRY[rid]
            print(f"{rid}  {getattr(cls, 'name', cls.__name__)}")
        return 0

    paths = args.paths or DEFAULT_PATHS
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"s2c2lint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]

    project, errors = load_project(paths)
    try:
        findings = errors + run_rules(project, select=select)
    except KeyError as e:
        print(f"s2c2lint: {e.args[0]}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None)
    if args.write_baseline:
        out = args.baseline or DEFAULT_BASELINE
        Baseline.from_findings(
            findings, reason="TODO: justify or fix").save(out)
        print(f"s2c2lint: wrote {len(findings)} suppression(s) to {out}")
        return 0

    suppressed, stale = 0, []
    if baseline_path is not None:
        baseline = Baseline.load(baseline_path)
        kept, stale = baseline.apply(findings)
        suppressed = len(findings) - len(kept)
        findings = kept

    if findings:
        print(render_line(findings))
    if stale:
        print(f"s2c2lint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed or moved — "
              f"regenerate with --write-baseline)", file=sys.stderr)
    if suppressed:
        print(f"s2c2lint: {suppressed} finding(s) suppressed by baseline",
              file=sys.stderr)

    if args.json_out:
        doc = render_json(findings, suppressed=suppressed,
                          stale_baseline=stale)
        if args.json_out == "-":
            print(doc)
        else:
            with open(args.json_out, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")

    n = len(findings)
    print(f"s2c2lint: {n} finding(s) in {len(project.files)} file(s)",
          file=sys.stderr)
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
