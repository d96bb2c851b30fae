#!/usr/bin/env python3
"""Time the host-side paths that `repro_torch.obs` instruments, with
recording off (the default), on whichever tree of the port is on
PYTHONPATH. Card only; it measures and checks nothing.

    PYTHONPATH=src python3 tools/time_obs_off.py [label] [--rounds R]

Per round, the host's time to issue one call (no synchronisation inside
the timed calls; 200 calls after a synchronised warm-up) of
`blas.axpy`, of a direct call of the same one-routine program, and of
`Executable.run` of the AXPYDOT program with a device α (every
recording site of a call: `program.call`, `kernel.group`,
`window.launch`, `window.scalars` and `window.copies`), at n = 2**16
float32, where the device work (a few µs) is far shorter than the
issue, and loop solves at n = 4096 timed on the host's clock, per
iteration (the loop waits on each iteration's status byte, so this is
the loop driver's host pace): a CG_LOOP solve (dataflow, an SPD matrix
from a seeded generator) and a `blas.pcg` solve (a Matérn-3/2 kernel
matrix of 4096 points in 8 dimensions with noise 0.05, a rank-15
pivoted Cholesky preconditioner, tolerance 0.01), each repeated on one
matrix (`cg_per_iteration`, `pcg_per_iteration`) and once on a fresh
copy of it at another address (`cg_fresh_per_iteration`,
`pcg_fresh_per_iteration`: a one-shot solve, which pays whatever the
loop does once for a new matrix). One JSON line with every round's
values and their median and quartiles; then the card's name and power
limit. To compare two trees, run each in turns in one call (parent,
change, change, parent, repeated).
"""
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch import blas
from repro_torch.blas import functional
from repro_torch.core import AXPYDOT_SPEC, Program
from repro_torch.solvers import LoopProgram, plain_gp, specs

N_VEC = 1 << 16
N_CG = 4096
REPS = 200


def host_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return issue


def per_iteration_ms(solve):
    """One solve's host ms per iteration, and its iterations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    iterations = int(res.iterations)
    return (time.perf_counter() - t0) * 1e3 / iterations, iterations


def summary(values):
    q = statistics.quantiles(values, n=4)
    return {"runs": values, "median": statistics.median(values),
            "q1": q[0], "q3": q[2]}


def main() -> int:
    args = sys.argv[1:]
    rounds = 10
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    label = args[0] if args else "tree"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N_VEC, generator=gen, device=dev)
    y = torch.randn(N_VEC, generator=gen, device=dev)
    prog = Program.from_spec(functional.routine_spec("axpy"), device="cuda")
    exe = blas.compile(AXPYDOT_SPEC, device="cuda")
    u = torch.randn(N_VEC, generator=gen, device=dev)
    neg_alpha = torch.tensor(-0.5, device=dev)
    m = torch.randn(N_CG, N_CG, generator=gen, device=dev) / N_CG ** 0.5
    a = (m @ m.T).add_(torch.eye(N_CG, device=dev))
    b = torch.randn(N_CG, generator=gen, device=dev)
    lp = LoopProgram(specs.CG_LOOP, mode="dataflow", device="cuda")
    x0 = torch.zeros_like(b)
    lp.solve(A=a, b=b, x0=x0)                 # builds and warms up
    X = torch.randn(N_CG, 8, dtype=torch.float64, generator=gen, device=dev)
    k = plain_gp.kernel_matrix(X, 4.0, 1.0, 0.05)
    precond = blas.pivoted_cholesky(k, 15, 0.05)
    y_gp = torch.randn(N_CG, generator=gen, device=dev)

    def pcg(mat):
        return blas.pcg(mat, y_gp, precond=precond, tol=0.01, device="cuda")
    pcg(k)
    # every fresh copy is kept, so that none lies where an earlier one
    # lay
    fresh = []
    torch.cuda.synchronize()
    out = {"axpy": [], "program": [], "axpydot_run": [],
           "cg_per_iteration": [], "cg_fresh_per_iteration": [],
           "pcg_per_iteration": [], "pcg_fresh_per_iteration": []}
    iterations = {}
    for _ in range(rounds):
        out["axpy"].append(host_ms(lambda: blas.axpy(0.5, x, y,
                                                     device="cuda")))
        out["program"].append(host_ms(lambda: prog(alpha=0.5, x=x, y=y)))
        out["axpydot_run"].append(host_ms(lambda: exe.run(
            neg_alpha=neg_alpha, w=x, v=y, u=u)))
        fresh += [a.clone(), k.clone()]
        solves = {"cg": lambda: lp.solve(A=a, b=b, x0=x0),
                  "cg_fresh": lambda: lp.solve(A=fresh[-2], b=b, x0=x0),
                  "pcg": lambda: pcg(k),
                  "pcg_fresh": lambda: pcg(fresh[-1])}
        for name, solve in solves.items():
            ms, iterations[name] = per_iteration_ms(solve)
            out[f"{name}_per_iteration"].append(ms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"label": label, "rounds": rounds,
                      "iterations": iterations, "nvidia_smi": smi,
                      **{k: summary(v) for k, v in out.items()}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
