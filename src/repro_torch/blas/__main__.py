"""`python -m repro_torch.blas` — public-API inspection CLI.

    python -m repro_torch.blas --list        the registry-derived API table
    python -m repro_torch.blas --spec dot    canonical spec behind blas.dot
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import routines as R

from . import api_table
from .functional import routine_spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.blas",
        description="Inspect the repro_torch.blas public API surface.")
    ap.add_argument("--list", action="store_true",
                    help="print the registry-derived routine table")
    ap.add_argument("--spec", metavar="ROUTINE",
                    help="print the canonical single-routine spec JSON "
                         "behind blas.<ROUTINE>")
    args = ap.parse_args(argv)
    if args.spec:
        try:
            R.get(args.spec)
        except KeyError as e:
            print(e, file=sys.stderr)
            return 2
        print(json.dumps(routine_spec(args.spec), indent=2))
        return 0
    if args.list:
        print(api_table())
        return 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
