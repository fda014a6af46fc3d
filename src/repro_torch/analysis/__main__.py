"""CLI for repro_torch.analysis — ``python -m repro_torch.analysis``.

Exit status: 0 when no *new* findings (suppressed and baselined findings
do not fail the run), 1 otherwise, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import (all_rules, format_human, format_json,
                                  load_baseline, run, save_baseline)

_PKG_DIR = Path(__file__).resolve().parent
DEFAULT_ROOT = _PKG_DIR.parent          # src/repro_torch
DEFAULT_BASELINE = _PKG_DIR / "baseline.json"


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      prog="python -m repro_torch.analysis",
      description="Static analysis for the PyTorch/CUDA port: semiring "
                  "consistency, lock discipline, capture safety.")
  parser.add_argument("--root", type=Path, default=DEFAULT_ROOT,
                      help=f"tree to analyze (default: {DEFAULT_ROOT})")
  parser.add_argument("--rules", default=None,
                      help="comma-separated rule ids and/or families "
                           "(semiring, locks, capture); default: all")
  parser.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                      help="grandfathered-findings file (default: "
                           "baseline.json next to the package)")
  parser.add_argument("--no-baseline", action="store_true",
                      help="ignore the baseline: report every finding")
  parser.add_argument("--update-baseline", action="store_true",
                      help="rewrite the baseline to grandfather every "
                           "current finding, then exit 0")
  parser.add_argument("--json", action="store_true",
                      help="machine-readable output (CI artifact)")
  parser.add_argument("--list-rules", action="store_true",
                      help="list registered rules and exit")
  args = parser.parse_args(argv)

  if args.list_rules:
    for r in sorted(all_rules().values(), key=lambda r: (r.family, r.name)):
      print(f"{r.name:28s} [{r.family}]  {r.doc}")
    return 0

  baseline = set() if args.no_baseline else load_baseline(args.baseline)
  try:
    report = run(args.root, rules=args.rules, baseline=baseline)
  except ValueError as e:          # bad --rules spec
    parser.error(str(e))

  if args.update_baseline:
    save_baseline(args.baseline, report.findings + report.baselined)
    print(f"baseline updated: {args.baseline} now grandfathers "
          f"{len(report.findings) + len(report.baselined)} finding(s)")
    return 0

  print(format_json(report) if args.json else format_human(report))
  return 0 if report.ok else 1


if __name__ == "__main__":
  sys.exit(main())
