"""Autotuner CLI, the reference's flags over the port's tuner.

    python -m repro_torch.tune --smoke --json tuning_table.json
    python -m repro_torch.tune --validate tuning_table.json

On the card by default (`--device cpu` times the plain versions on a
host with no card). Default (and --smoke) runs sweep two registry
routines plus one
level-2 anchored fusion chain, print the tune reports, export the
resulting table, and exit non-zero if the table fails schema
validation or any recorded tuned config loses to its default by more
than --max-loss (10% by default) — the "tuning must never make things
worse" gate.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import autotuner, store as S

# the canonical anchored chain (symv -> dot), the reference CLI's
SYMV_DOT = {
    "name": "symv_dot",
    "routines": [
        {"blas": "symv", "name": "mv",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": "d.x"}},
        {"blas": "dot", "name": "d", "inputs": {"y": "x"},
         "outputs": {"out": "q"}},
    ],
}
CHAINS = {"symv_dot": SYMV_DOT}


def _loss_violations(doc, max_loss: float) -> list:
    bad = []
    for key, rec in doc.get("entries", {}).items():
        us, default_us = rec.get("us"), rec.get("default_us")
        if not isinstance(us, (int, float)) or \
                not isinstance(default_us, (int, float)):
            continue                    # schema validation flags these
        if default_us > 0 and us > default_us * (1.0 + max_loss):
            bad.append(
                f"entries[{key}]: tuned {us:.1f}us loses to default "
                f"{default_us:.1f}us by more than {max_loss:.0%}")
    return bad


def _check(doc, max_loss: float) -> int:
    problems = S.validate_doc(doc) + _loss_violations(doc, max_loss)
    if problems:
        print("TUNING-TABLE VALIDATION FAILED:", file=sys.stderr)
        for p in problems:
            print(f"  {p}", file=sys.stderr)
        return 1
    n_e = len(doc.get("entries", {}))
    n_a = len(doc.get("artifacts", {}))
    print(f"# table OK: {n_e} entries, {n_a} artifacts "
          f"(schema {doc.get('schema')})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--routines", nargs="*", default=["gemv", "symv"],
                    help="registry routines to sweep")
    ap.add_argument("--chains", nargs="*", default=["symv_dot"],
                    choices=sorted(CHAINS), help="anchored chains")
    ap.add_argument("--n", type=int, default=512,
                    help="problem size (matrices are n x n)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max timed candidate measurements per program")
    ap.add_argument("--iters", type=int, default=autotuner.DEFAULT_ITERS)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny budget + size (the CI tune-smoke job)")
    ap.add_argument("--json", metavar="PATH",
                    help="export the tuning table document")
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an exported table and exit")
    ap.add_argument("--max-loss", type=float, default=0.10,
                    help="max tolerated tuned-vs-default regression")
    ap.add_argument("--device", default=None,
                    help="'cpu' to time the plain versions on a host "
                         "with no card (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.validate:
        try:
            doc = json.loads(open(args.validate).read())
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read {args.validate}: {e}", file=sys.stderr)
            return 1
        return _check(doc, args.max_loss)

    n, budget, iters = args.n, args.budget, args.iters
    if args.smoke:
        n, iters = min(n, 256), 1
        budget = 6 if budget is None else budget

    store = S.get_store()
    for name in args.routines:
        rep = autotuner.tune_routine(name, n, budget=budget,
                                     iters=iters, store=store,
                                     device=args.device)
        print(rep)
    for cname in args.chains:
        rep = autotuner.tune_program(
            CHAINS[cname], {"A": (n, n), "x": (n,)}, budget=budget,
            iters=iters, store=store, device=args.device)
        print(rep)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(store.doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.json}")
    return _check(store.doc, args.max_loss)


if __name__ == "__main__":
    sys.exit(main())
