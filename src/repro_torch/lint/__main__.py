"""``python -m repro_torch.lint [--check] [--select] [--list-rules] [paths]``:
the port's linter.

The default paths are the port's trees (``src/repro_torch``,
``benchmarks_torch``, ``chip_smoke.py``), resolved from the root of the
repository (three levels above this package), so runs from any directory
agree. Exit code 1 on any violation; ``--check`` is the explicit spelling
of the same gate. Imports no torch.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.lint.engine import lint_paths
from repro_torch.lint.rules import RULES

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_TREES = ("src/repro_torch", "benchmarks_torch", "chip_smoke.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static analysis of the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {' '.join(DEFAULT_TREES)})")
    ap.add_argument("--check", action="store_true",
                    help="gate mode: identical to the default, spelled as a gate")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, r in sorted(RULES.items()):
            print(f"{code}  {r.summary}")
        return 0

    paths = args.paths or [
        p for p in (os.path.join(REPO_ROOT, t) for t in DEFAULT_TREES)
        if os.path.exists(p)]
    select = args.select.split(",") if args.select else None
    violations = lint_paths(paths, select=select)
    for v in violations:
        print(v.render())
    n = len(violations)
    print(f"jaxlint: {n} violation(s)" if n else "jaxlint: clean")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
