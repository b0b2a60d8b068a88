"""CLI: `python -m repro_torch.analysis [--strict] [--json]
[--write-contracts PATH]`.

Exit status: 0 when every proof obligation holds (all findings either
absent or justified in `analysis_suppressions_torch.txt`, no stale
suppressions); 1 otherwise. `--strict` is accepted for explicitness and
CI readability — the gate is always strict; without it the report still
prints but a dirty tree only warns (exit 0), which is the local
iterate-on-a-fix mode.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from . import (DEFAULT_SUPPRESSION_FILE, apply_suppressions,
               load_suppressions, render_report, run_all, to_json)
from .findings import REPO_ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any active finding or stale "
                         "suppression (CI mode)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable findings JSON")
    ap.add_argument("--write-contracts", metavar="PATH", nargs="?",
                    const=str(REPO_ROOT / "docs" /
                              "kernel_contracts_torch.md"),
                    default=None,
                    help="write the contract report of the CUDA launches "
                         "(default docs/kernel_contracts_torch.md)")
    ap.add_argument("--suppressions", metavar="PATH",
                    default=str(DEFAULT_SUPPRESSION_FILE),
                    help="suppression file (default %(default)s)")
    args = ap.parse_args(argv)

    findings, coverage, contracts = run_all()
    sups, malformed = load_suppressions(pathlib.Path(args.suppressions))
    active, suppressed, stale = apply_suppressions(
        findings, sups, pathlib.Path(args.suppressions))
    active = malformed + active

    if args.write_contracts:
        out = pathlib.Path(args.write_contracts)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(contracts)
        print(f"wrote {out}", file=sys.stderr)

    if args.json:
        print(to_json(active, suppressed, stale, coverage))
    else:
        print(render_report(active, suppressed, stale, coverage))

    dirty = bool(active or stale)
    if dirty and not args.strict:
        print("(non-strict: exiting 0 despite findings)", file=sys.stderr)
    return 1 if (dirty and args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
