"""An exact GP's predictive solves: the Matérn-3/2 kernel matrix
K̂ = K + σ²I of the deployment's n training inputs X ~ N(0, I_d) (drawn
from the configuration's `data_seed`: one dataset, the same in every
run), made on the card a block of rows at a time (each block in
float64, rounded once to float32), its rank-k pivoted Cholesky
preconditioner (`blas.pivoted_cholesky`, built once, in set-up) and a
pool of right-hand sides y ~ N(0, I_n) from the run's seed, for
`blas.solve(K̂, y, precond=P)`.

The check, over every solve the run kept (`gp_reference`, each number
in float64 with K̂'s float32 entries as they are):

- `relres_true_max`: the largest true relative residual ‖y − K̂x‖ / ‖y‖;
- `resid_gap_max`: the largest gap between that and the residual the
  program reported (`SolverResult.residual` / ‖y‖): float32 products
  keep the recurrence near the true residual, TF32 ones do not;
- `iters_off_max`: the largest |program iterations − the float64
  reference PCG's on the same y with its own rank-k factor|: a solve
  that dropped or weakened the preconditioner takes more.

Controls (`use_control`) take the program's place for a whole run:
`tf32`, the reference PCG in float32 with each operator product's
operands rounded to TF32 (the operator rounded once, a second 16 GiB;
each solve's iterations and residuals go to standard error), its
variant `tf32-vector`, and `cg`, the program's own PCG with its
preconditioner made σ²I: plain CG.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import types

import torch

from portbench import gp_reference, gp_work, work

NAMES = ("relres_true_max", "resid_gap_max", "iters_off_max")


def build(run) -> None:
    from repro_torch import blas

    if not hasattr(blas, "pivoted_cholesky"):
        raise RuntimeError("this program has no blas.pivoted_cholesky: it "
                           "cannot run a preconditioned solve")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = run.config, run.device
    n, d = int(cfg["n"]), int(cfg["d"])
    data = torch.Generator(device=dev).manual_seed(int(cfg["data_seed"]))
    X = torch.randn(n, d, dtype=torch.float64, generator=data, device=dev)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    Y = torch.randn(int(run.traffic["rhs_pool"]), n, generator=gen,
                    device=dev)
    K = gp_reference.kernel_matrix(X, float(cfg["lengthscale"]),
                                   float(cfg["outputscale"]),
                                   float(cfg["noise"]))
    P = blas.pivoted_cholesky(K, int(cfg["precond_rank"]),
                              float(cfg["noise"]))
    run.inputs.update(X=X, Y=Y, K=K, precond=P)


def rhs(run, i: int) -> torch.Tensor:
    """The right-hand side of solve i: the pool's (i mod its size)."""
    Y = run.inputs["Y"]
    return Y[i % Y.shape[0]]


def solve_args(run) -> dict:
    """`blas.solve`'s keyword arguments for every solve of the run."""
    cfg = run.config
    return {"tol": float(cfg["tol"]), "max_iters": int(cfg["max_iters"]),
            "precond": run.inputs["precond"], "mode": cfg["mode"],
            "device": run.device}


def reference_iterations(run, indices) -> dict:
    """The float64 reference PCG's iterations on each pool index, with
    its own rank-k factor of K̂ − σ²I; computed once an index (a panel
    of every new one at a time) and kept in `run.state`."""
    cache = run.state.setdefault("ref_iters", {})
    todo = sorted(set(indices) - set(cache))
    if todo:
        cfg, K = run.config, run.inputs["K"]
        noise = float(cfg["noise"])
        if "ref_factor" not in run.state:
            L, _ = gp_reference.pivoted_cholesky(
                K, int(cfg["precond_rank"]), noise)
            run.state["ref_factor"] = (L, gp_reference.woodbury(L, noise))
        L, W = run.state["ref_factor"]
        B = run.inputs["Y"][todo].T.to(torch.float64)
        _, iters, _ = gp_reference.pcg(K, B, L, W, noise,
                                       tol=float(cfg["tol"]),
                                       max_iters=int(cfg["max_iters"]))
        cache.update(zip(todo, iters.tolist()))
    return cache


def check(run) -> list:
    limits = run.config["limits"]
    answers = [a for w in run.windows.values() for a in w.answers]
    if not answers:
        return [(name, float("inf"), float(limits[name])) for name in NAMES]
    pool = run.inputs["Y"].shape[0]
    idx = [i % pool for i, _, _, _ in answers]
    B = run.inputs["Y"][idx].T.to(torch.float64)
    X = torch.stack([x for _, x, _, _ in answers], 1)
    bnorm = torch.linalg.vector_norm(B, dim=0)
    true = torch.linalg.vector_norm(
        B - gp_reference.matmul(run.inputs["K"], X), dim=0) / bnorm
    reported = torch.tensor([r for _, _, _, r in answers],
                            dtype=torch.float64, device=B.device) / bnorm
    ref = reference_iterations(run, idx)
    off = max(abs(it - ref[j]) for j, (_, _, it, _) in zip(idx, answers))
    values = (float(true.max()), float((true - reported).abs().max()),
              float(off))
    return [(name, v, float(limits[name])) for name, v in zip(NAMES, values)]


def least_seconds(run, window):
    """The least time of the window's solves at the card's peaks, each
    solve reckoned at the reference's iterations on its y; None where
    the card has no entry or the check has not reckoned them."""
    peak, ref = run.peak, run.state.get("ref_iters")
    if peak is None or not ref or not window.answers:
        return None
    n, k = int(run.config["n"]), int(run.config["precond_rank"])
    pool = run.inputs["Y"].shape[0]
    total = 0.0
    for i, _, _, _ in window.answers:
        if i % pool not in ref:
            return None
        nbytes, flops = gp_work.solve_work(n, k, ref[i % pool])
        total += work.least_seconds(nbytes, flops, peak)
    return total


def _result(x, iterations: int, residual: float, converged: bool):
    """What the driver reads of a solve: the answer and its one rung."""
    attempt = types.SimpleNamespace(
        solver="control", status_name="CONVERGED" if converged
        else "MAX_ITERS", iterations=iterations, residual=residual)
    return types.SimpleNamespace(x=x, attempts=[attempt])


def replace_solve(make, setattr_=setattr) -> None:
    """Put `make(solve)` in the place of `repro_torch.blas.solve` for
    the process (through `setattr_`, which a test gives as its
    monkeypatch); `solve` is the program's own."""
    from repro_torch import blas

    setattr_(blas, "solve", make(blas.solve))


def use_control(setattr_=setattr, kind: str = "tf32") -> None:
    """A control in the program's place, judged by `check` as the
    program: `tf32` (the reference PCG in float32, each operator
    product's operands rounded to TF32, the reference's own float32
    factor), `tf32-vector` (the same with only the vector operand
    rounded, the operator left in float32) or `cg` (the program's own
    solve with factors of zeros, P = σ²I: plain CG through PCG's loop
    and its guards)."""
    if kind == "cg":
        def make(solve):
            def control(A, b, x0=None, *, precond, **kw):
                # rank-k factors of zeros: P = σ²I, so PCG is plain CG
                zero = torch.zeros_like(precond.L)
                plain = dataclasses.replace(precond, L=zero, W=zero)
                return solve(A, b, x0, precond=plain, **kw)
            return control
    elif kind in ("tf32", "tf32-vector"):
        held = {}

        def make(solve):
            def control(A, b, x0=None, *, precond, tol, max_iters,
                        **kw):
                shift = float(precond.shift)
                if held.get("of") is not A:     # one operator at a time
                    held.clear()
                    L, _ = gp_reference.pivoted_cholesky(
                        A, precond.rank, shift, torch.float32)
                    held.update(of=A, L=L, W=gp_reference.woodbury(L, shift),
                                A=gp_reference.tf32_copy(A)
                                if kind == "tf32" else A)
                x, iters, rnorm = gp_reference.pcg(
                    held["A"], b[:, None], held["L"], held["W"], shift,
                    tol=tol, max_iters=max_iters, tf32=True)
                bnorm = float(torch.linalg.vector_norm(b))
                converged = float(rnorm[0]) <= tol * bnorm
                true = float(torch.linalg.vector_norm(
                    b.double() - gp_reference.matmul(A, x[:, 0]))) / bnorm
                print(json.dumps({"control": kind,
                                  "iterations": int(iters[0]),
                                  "relres_reported": float(rnorm[0]) / bnorm,
                                  "relres_true": true,
                                  "converged": converged}),
                      file=sys.stderr, flush=True)
                return _result(x[:, 0], int(iters[0]), float(rnorm[0]),
                               converged)
            return control
    else:
        raise ValueError(f"no control {kind!r}; have 'tf32', "
                         f"'tf32-vector', 'cg'")
    replace_solve(make, setattr_)
