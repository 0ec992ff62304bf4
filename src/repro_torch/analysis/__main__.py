"""CLI of the port's repro-lint (run from the repo root, ``PYTHONPATH=src``).

  python -m repro_torch.analysis                     # lint + gate vs baseline
  python -m repro_torch.analysis --update-baseline   # re-record the ratchet
  python -m repro_torch.analysis path/to/file.py     # lint specific paths
  python -m repro_torch.analysis --no-baseline       # raw findings, no ratchet

Exit codes: 0 clean (or everything baselined), 1 new findings, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .baseline import Baseline
from .lint import RULES, run_lint

_DEFAULT_PATHS = ["src/repro_torch"]
_DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint of the port: codebase-specific static "
                    "analysis (rules RL001-RL005, see lint.py)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {_DEFAULT_PATHS})")
    ap.add_argument("--root", default=".",
                    help="path findings are reported relative to "
                         "(baseline keys; default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"ratchet file (default: {_DEFAULT_BASELINE} "
                         "under --root)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the ratchet: any finding fails")
    ap.add_argument("--update-baseline", action="store_true",
                    help="re-record the ratchet from current findings "
                         "(prunes fixed entries) and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. RL001,RL003")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    paths = [Path(p) for p in (args.paths or [])]
    if not paths:
        paths = [root / p for p in _DEFAULT_PATHS if (root / p).exists()]
    rules = None
    if args.rules:
        rules = {r.strip().upper() for r in args.rules.split(",")}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2

    report = run_lint(paths, root=root, rules=rules)

    bl_path = Path(args.baseline) if args.baseline \
        else root / _DEFAULT_BASELINE
    if args.update_baseline:
        Baseline.from_findings(report.findings).save(bl_path)
        print(f"baseline re-recorded: {len(report.findings)} finding(s) "
              f"-> {bl_path}")
        return 0

    baseline = Baseline() if args.no_baseline else Baseline.load(bl_path)
    diff = baseline.diff(report.findings)

    if args.as_json:
        print(json.dumps({
            "files": report.files,
            "new": [vars(f) | {"key": f.key} for f in diff.new],
            "baselined": [f.key for f in diff.baselined],
            "stale": diff.stale,
            "suppressed": [f.key for f in report.suppressed],
            "ok": diff.ok,
        }, indent=2))
        return 0 if diff.ok else 1

    for f in diff.new:
        print(f"NEW  {f}")
    for f in diff.baselined:
        print(f"OLD  {f}")
    tally = ", ".join(f"{r}={n}" for r, n in
                      sorted(report.by_rule().items())) or "none"
    print(f"repro-lint: {report.files} file(s), findings: {tally} "
          f"({len(diff.new)} new, {len(diff.baselined)} baselined, "
          f"{len(report.suppressed)} suppressed)")
    if diff.stale:
        print(f"note: {len(diff.stale)} stale baseline entr(y/ies) — "
              "offenders fixed; run --update-baseline to prune:")
        for k in diff.stale:
            print(f"  STALE {k}")
    if diff.new:
        print("FAIL: new findings above the baseline ratchet. Fix them, "
              "or (deliberately) re-record with --update-baseline.")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
