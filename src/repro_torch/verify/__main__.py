"""CLI: ``python -m repro_torch.verify <spec.json ...> [--all-shipped]``.

Verifies each spec with the static analyzer and prints findings —
human-readable by default, one JSON document with ``--json`` for CI.
Exit status 0 when no spec has error-severity findings, 1 otherwise
(warnings and infos do not fail the run).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import verify


def _shipped():
    """All shipped specs: the five solver loop programs plus the
    canonical single-routine spec for every registered routine."""
    from repro_torch.blas import functional
    from repro_torch.core import routines as R
    from repro_torch.solvers import specs as solver_specs

    out = [("CG_LOOP", solver_specs.CG_LOOP),
           ("JACOBI_LOOP", solver_specs.JACOBI_LOOP),
           ("BICGSTAB_LOOP", solver_specs.BICGSTAB_LOOP),
           ("GMRES_LOOP", solver_specs.GMRES_LOOP),
           ("BLOCK_CG_LOOP", solver_specs.BLOCK_CG_LOOP)]
    out += [(f"routine:{name}", functional.routine_spec(name))
            for name in R.names()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="Statically verify BLAS dataflow/loop specs "
                    "(nothing compiled; exit 1 on errors).")
    ap.add_argument("specs", nargs="*", metavar="SPEC",
                    help="spec JSON file(s) to verify")
    ap.add_argument("--all-shipped", action="store_true",
                    help="verify every shipped solver loop spec and "
                         "registry routine spec")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one machine-readable JSON document")
    ap.add_argument("--mode", default="dataflow",
                    choices=("dataflow", "nodataflow", "reference"),
                    help="lowering mode the analysis assumes "
                         "(default: dataflow)")
    args = ap.parse_args(argv)

    targets = list(_shipped()) if args.all_shipped else []
    for path in args.specs:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                targets.append((path, json.load(fh)))
        except (OSError, ValueError) as e:
            # unreadable file / invalid JSON — not a spec finding
            print(f"{path}: {e}", file=sys.stderr)
            return 2
    if not targets:
        ap.error("nothing to verify: pass spec files or --all-shipped")

    results = [(label, verify.analyze(raw, mode=args.mode))
               for label, raw in targets]

    failed = [label for label, r in results if not r.ok]
    if args.as_json:
        doc = {"ok": not failed,
               "specs": [dict(r.to_dict(), label=label)
                         for label, r in results]}
        print(json.dumps(doc, indent=2))
    else:
        for label, r in results:
            if r.diagnostics:
                print(r.format())
            else:
                print(f"{r.program or label}: clean")
        total_err = sum(len(r.errors) for _, r in results)
        total_warn = sum(len(r.warnings) for _, r in results)
        print(f"verified {len(results)} spec(s): {total_err} "
              f"error(s), {total_warn} warning(s)"
              + (f"; failing: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
