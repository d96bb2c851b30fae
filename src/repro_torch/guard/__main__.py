"""`python -m repro_torch.guard --chaos-smoke` — the fault-injection drill.

Runs the full fault matrix over the shipped loop specs: every fault
kind (nan / inf / bitflip / scale, plus a scale-0 breakdown
provocation) injected at a fixed iteration into every solver, then
asserts the in-loop guards (1) detect the fault with a failure status
within DETECTION_SLACK iterations of the injection point and (2) the
escalation driver still recovers a correct solution. A filesystem
drill corrupts and truncates a tuning table and checks the quarantine
path: 23 solver cells and 2 filesystem cells. The JSON fault report
(one row per cell) goes to --report; the exit status is nonzero if any
cell fails, and a cell that raises is a failed cell (its row records
the exception).

    python -m repro_torch.guard --chaos-smoke                # the card
    python -m repro_torch.guard --chaos-smoke --device cpu   # the CPU
"""
from __future__ import annotations

import argparse
import json
import sys
import time

DETECTION_SLACK = 2    # guards must trip within this many iterations

# fault target prefix + injection iteration per solver: the target is
# the stage-program name prefix (BiCGStab's stages are `bicg_*`,
# block-CG's body stages are `block_cg_*`); GMRES counts restarts and
# converges within ~2, so it gets poked earlier than the
# linear-iteration solvers
TARGETS = {"cg": ("cg", 3), "bicgstab": ("bicg", 3),
           "jacobi": ("jacobi", 3), "gmres": ("gmres", 1),
           "block_cg": ("block_cg", 3)}


def _case_matrix():
    from repro_torch.guard import chaos

    cases = []
    for solver in ("cg", "bicgstab", "jacobi", "gmres", "block_cg"):
        for kind in chaos.FAULT_KINDS:
            cases.append((solver, kind, {}))
        # scale by 0 zeroes the guarded scalars -> breakdown sentinel
        # (only CG/BiCGStab/block-CG carry breakdown guards; block-CG's
        # sentinel is the per-RHS Gram diagonal, so zeroing it must
        # trip on the whole panel)
        if solver in ("cg", "bicgstab", "block_cg"):
            cases.append((solver, "scale", {"factor": 0.0}))
    return cases


def _system(n: int = 24, seed: int = 0, rhs: int = 0):
    """SPD system (numpy float32, from `seed`); ``rhs > 0`` returns an
    (n, rhs) right-hand-side panel (one column per system) instead of a
    vector."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    a = (m @ m.T + n * np.eye(n, dtype=np.float32))
    shape = (n, rhs) if rhs else (n,)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def _compile_faulted(solver, plan, *, mode, device):
    from repro_torch import blas
    from repro_torch.solvers import specs
    raw = {"cg": specs.CG_LOOP, "bicgstab": specs.BICGSTAB_LOOP,
           "jacobi": specs.JACOBI_LOOP,
           "block_cg": specs.BLOCK_CG_LOOP}.get(solver)
    kw = {"max_iters": 100}
    if raw is None:
        raw, kw = specs.gmres_loop(8), {}
    return blas.compile(raw, mode=mode, device=device, fault=plan, **kw)


def _run_cell(solver, kind, extra, *, mode="dataflow", device=None):
    """One fault-matrix cell: inject, check detection, check recovery."""
    import numpy as np
    import torch

    from repro_torch import blas
    from repro_torch.guard import chaos
    from repro_torch.guard import status as ST
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    # block-CG drills a 3-column RHS panel; everything else a vector
    a_np, b_np = _system(rhs=3 if solver == "block_cg" else 0)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    target, inject_at = TARGETS[solver]
    plan = chaos.FaultPlan(program=target, kind=kind,
                           iteration=inject_at, **extra)
    row = {"solver": solver, "kind": kind, **extra,
           "iteration": inject_at}
    t0 = time.perf_counter()
    try:
        exe = _compile_faulted(solver, plan, mode=mode, device=dev)
        if solver == "block_cg":
            inputs = {"A": a, "B": b, "x0": torch.zeros_like(b)}
        else:
            inputs = {"A": a, "b": b, "x0": torch.zeros_like(b)}
        if solver == "jacobi":
            from repro_torch.solvers import iterative
            inputs["dinv"] = iterative.jacobi_dinv(a, b.dtype)
            inputs["omega"] = 1.0
        res = exe.run(tol=1e-6, **inputs)
        code = int(res.status)
        row["status"] = ST.status_name(code)
        row["iterations"] = int(res.iterations)
        row["detected"] = bool(
            ST.is_failure(code)
            and int(res.iterations) <= inject_at + DETECTION_SLACK)
        if not row["detected"]:
            row["error"] = (
                f"fault not detected: status={row['status']} after "
                f"{row['iterations']} iterations "
                f"(injected at {inject_at})")
        # graceful degradation: the same fault through blas.solve must
        # still come back with a correct solution (fault arms the
        # first attempt only)
        rec = blas.solve(a, b, tol=1e-6, mode=mode, device=dev,
                         fault=plan)
        x_ref = np.linalg.solve(a_np.astype(np.float64),
                                b_np.astype(np.float64))
        ok = bool(np.allclose(rec.x.double().cpu().numpy(), x_ref,
                              atol=1e-2))
        row["recovered"] = ok
        row["attempts"] = [
            {"solver": at.solver, "action": at.action,
             "status": at.status_name} for at in rec.attempts]
        if not ok:
            row["error"] = "escalation returned a wrong solution"
        row["ok"] = row["detected"] and ok
    except Exception as e:            # a crash is a failed cell
        row["ok"] = False
        row["error"] = f"{type(e).__name__}: {e}"
    row["duration_s"] = round(time.perf_counter() - t0, 3)
    return row


def _fs_drill(tmpdir):
    """Filesystem chaos: corrupt + truncate a tuning table; the store
    must quarantine and rebuild, never crash or trust garbage."""
    import pathlib

    from repro_torch.guard import chaos
    from repro_torch.tune import store as tune_store

    rows = []
    root = pathlib.Path(tmpdir)
    for name, damage in (("corrupt", chaos.corrupt_json),
                         ("truncate", chaos.truncate_file)):
        row = {"solver": "tune.store", "kind": name}
        t0 = time.perf_counter()
        try:
            path = root / f"table_{name}.json"
            table = tune_store.TuningTable(path)
            table.doc["seq"] = 1
            table.doc["entries"]["probe|64|dataflow|fuse=1|"
                                 "anchor=1|cpu"] = {
                "tiles": {"block_m": 8, "block_n": 8, "block_k": 8},
                "us": 1.0, "default_us": 2.0, "seq": 1}
            table.save()
            damage(path)
            reread = tune_store.TuningTable(path)
            quarantined = path.with_name(path.name + ".corrupt")
            row["ok"] = (reread.doc["entries"] == {}
                         and quarantined.exists())
            if not row["ok"]:
                row["error"] = "corrupt table not quarantined"
        except Exception as e:
            row["ok"] = False
            row["error"] = f"{type(e).__name__}: {e}"
        row["duration_s"] = round(time.perf_counter() - t0, 3)
        rows.append(row)
    return rows


def chaos_smoke(report_path=None, *, device=None,
                quiet: bool = False) -> dict:
    """Run every cell in dataflow mode, as the reference's drill does;
    returns the report (``report["failed"]`` counts the failed cells).
    `device` defaults to the CUDA card; `quiet` prints nothing."""
    import tempfile

    rows = []
    for solver, kind, extra in _case_matrix():
        row = _run_cell(solver, kind, extra, device=device)
        rows.append(row)
        if quiet:
            continue
        tag = "ok" if row["ok"] else "FAIL"
        label = kind + (" (factor=0)" if extra else "")
        print(f"  {tag:<4} {solver:<9} {label:<18} "
              f"-> {row.get('status', '?'):<10} "
              f"iters={row.get('iterations', '?')} "
              f"recovered={row.get('recovered', '?')}")
        if not row["ok"]:
            print(f"       {row.get('error')}")
    with tempfile.TemporaryDirectory() as tmp:
        for row in _fs_drill(tmp):
            rows.append(row)
            if not quiet:
                tag = "ok" if row["ok"] else "FAIL"
                print(f"  {tag:<4} {row['solver']:<9} {row['kind']}")

    failed = [r for r in rows if not r["ok"]]
    report = {"cases": len(rows), "failed": len(failed),
              "detection_slack": DETECTION_SLACK, "mode": "dataflow",
              "rows": rows}
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        if not quiet:
            print(f"report -> {report_path}")
    if not quiet:
        print(f"chaos smoke: {len(rows) - len(failed)}/{len(rows)} "
              f"cells passed")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.guard",
        description="fault-injection drills for the guarded solvers")
    ap.add_argument("--chaos-smoke", action="store_true",
                    help="run the full fault matrix over the shipped "
                         "loop specs")
    ap.add_argument("--report", default=None,
                    help="write the JSON fault report here")
    ap.add_argument("--device", default=None,
                    help="where the solves run (default: the CUDA card; "
                         "'cpu' runs every kernel's plain version)")
    args = ap.parse_args(argv)
    if not args.chaos_smoke:
        ap.print_help()
        return 2
    report = chaos_smoke(args.report, device=args.device)
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
