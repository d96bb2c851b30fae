"""Solver convenience functions on the `blas.compile` -> `Executable`
path.

`cg`, `block_cg`, `jacobi`, `bicgstab` and `gmres` run the JSON loop
specs (`solvers.specs.CG_LOOP` / `BLOCK_CG_LOOP` / `JACOBI_LOOP` /
`BICGSTAB_LOOP` / `gmres_loop(m)`) through `compile()`, and `pcg` runs
`solvers.pcg.PCG_LOOP` with a `pivoted_cholesky` preconditioner;
`power_iteration` wraps the class-based `solvers.PowerIteration` (its
Rayleigh-quotient metric is beyond the loop grammar) behind the same
Executable handle. All return the standard `SolverResult`, and run on
the CUDA card unless given `device="cpu"`.

Executables are memoized per (solver, config, mode, device, max_iters),
so repeated calls reuse the lowered loop; a faulted compile (`solve`'s
first attempt under a fault plan) never enters or comes from that memo.
`solve` runs these solvers under the escalation ladder
(`guard.escalate`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.solvers import iterative, pcg as pcg_spec, specs
from repro_torch.solvers.driver import SolverResult
from repro_torch.solvers.pcg import (PivotedCholesky,  # noqa: F401
                                     pivoted_cholesky)

from .executable import Executable, compile as _compile

_EXECUTABLES: dict = {}


def _loop_executable(name: str, raw, mode: str, device,
                     max_iters: Optional[int], *,
                     config: tuple = ()) -> Executable:
    key = ("loop", name, config, mode, device, max_iters)
    exe = _EXECUTABLES.get(key)
    if exe is None:
        exe = _compile(raw, mode=mode, device=device, max_iters=max_iters)
        _EXECUTABLES[key] = exe
    return exe


def _solver_executable(name: str, factory, mode: str, device,
                       max_iters: int) -> Executable:
    key = ("class", name, mode, device, max_iters)
    exe = _EXECUTABLES.get(key)
    if exe is None:
        exe = Executable.from_solver(
            factory(mode=mode, device=device, max_iters=max_iters))
        _EXECUTABLES[key] = exe
    return exe


def cg(A, b, x0=None, *, tol: float = 1e-6, max_iters: int = 500,
       mode: str = "dataflow", device=None) -> SolverResult:
    """Conjugate gradient for SPD systems — the `specs.CG_LOOP` JSON
    loop program on the unified Executable path."""
    exe = _loop_executable("cg", specs.CG_LOOP, mode, device, max_iters)
    if x0 is None:
        x0 = torch.zeros_like(b)
    return exe.run(A=A, b=b, x0=x0, tol=tol)


def pcg(A, b, x0=None, *, precond: PivotedCholesky, tol: float = 1e-2,
        max_iters: int = 1000, mode: str = "dataflow",
        device=None) -> SolverResult:
    """Preconditioned conjugate gradient for SPD systems A = K + σ²I —
    the `solvers.pcg.PCG_LOOP` JSON loop program, preconditioned by
    P = L Lᵀ + σ²I (`precond`, from `pivoted_cholesky(A, k, σ²)`)
    through Woodbury. The defaults are GPyTorch's for predictions
    (relative residual 0.01, at most 1000 iterations)."""
    exe = _loop_executable("pcg", pcg_spec.PCG_LOOP, mode, device,
                           max_iters)
    if x0 is None:
        x0 = torch.zeros_like(b)
    return exe.run(A=A, b=b, x0=x0, tol=tol, **precond.operands())


def block_cg(A, B, X0=None, *, tol: float = 1e-6, max_iters: int = 500,
             mode: str = "dataflow", device=None) -> SolverResult:
    """Blocked conjugate gradient for SPD systems with an (n, s)
    right-hand-side panel — the `specs.BLOCK_CG_LOOP` JSON loop program.
    Each iteration shares ONE gemm matvec across all s right-hand sides
    (a gemm-anchored fused group computes Q = A P and the Gram diagonal
    diag(PᵀQ) in a single kernel); the per-column recurrences are
    otherwise exactly CG, so `result.x` matches solving each column
    independently. The stop rule tracks the worst column's residual."""
    if B.ndim != 2:
        raise ValueError(
            f"block_cg: B must be an (n, s) panel, got shape "
            f"{tuple(B.shape)}")
    exe = _loop_executable("block_cg", specs.BLOCK_CG_LOOP, mode, device,
                           max_iters)
    if X0 is None:
        X0 = torch.zeros_like(B)
    return exe.run(A=A, B=B, x0=X0, tol=tol)


def jacobi(A, b, x0=None, *, tol: float = 1e-6, max_iters: int = 1000,
           omega: float = 1.0, richardson: bool = False,
           mode: str = "dataflow", device=None) -> SolverResult:
    """Weighted Jacobi / Richardson — the `specs.JACOBI_LOOP` JSON loop
    program; D⁻¹ rides along as a data operand."""
    exe = _loop_executable("jacobi", specs.JACOBI_LOOP, mode, device,
                           max_iters)
    if x0 is None:
        x0 = torch.zeros_like(b)
    dinv = (torch.ones_like(b) if richardson
            else iterative.jacobi_dinv(A, b.dtype))
    return exe.run(A=A, b=b, x0=x0, dinv=dinv, omega=float(omega), tol=tol)


def bicgstab(A, b, x0=None, *, tol: float = 1e-6, max_iters: int = 500,
             mode: str = "dataflow", device=None) -> SolverResult:
    """Stabilized bi-CG for general square systems — the
    `specs.BICGSTAB_LOOP` JSON loop program: the ‖s‖ early exit is a
    spec-level `cond` stage against the driver-bound `threshold`. The
    class-based `solvers.BiCGStab` remains as its parity oracle."""
    exe = _loop_executable("bicgstab", specs.BICGSTAB_LOOP, mode, device,
                           max_iters)
    if x0 is None:
        x0 = torch.zeros_like(b)
    return exe.run(A=A, b=b, x0=x0, tol=tol)


def gmres(A, b, x0=None, *, tol: float = 1e-6, restart: int = 20,
          max_restarts: int = 50, mode: str = "dataflow",
          device=None) -> SolverResult:
    """Restarted GMRES(m) for general square systems — the
    `specs.gmres_loop(restart)` JSON loop program: nested count loops
    over stacked Krylov state (Arnoldi / Givens sweep /
    back-substitution), one lowered loop per `restart` value.
    `result.iterations` counts restarts; each runs `restart` Arnoldi
    steps."""
    if restart < 1:
        raise ValueError(f"gmres: restart must be >= 1, got {restart}")
    exe = _loop_executable(
        "gmres", specs.gmres_loop(restart, max_restarts=max_restarts),
        mode, device, max_restarts, config=(restart, max_restarts))
    if x0 is None:
        x0 = torch.zeros_like(b)
    return exe.run(A=A, b=b, x0=x0, tol=tol)


def solve(A, b, x0=None, *, tol: float = 1e-6, max_iters: int = 500,
          policy=None, mode: str = "dataflow", device=None,
          fault=None, precond: Optional[PivotedCholesky] = None
          ) -> SolverResult:
    """Robust solve with graceful degradation: runs the guarded
    iterative solvers under an `EscalationPolicy` (default
    CG -> BiCGStab -> GMRES -> float64 dense direct; with a `precond`
    (`pivoted_cholesky`) PCG first, then that chain; a matrix `b` with
    one column per system runs block-CG -> float64 dense direct),
    reacting to `guard.status` failure codes with retries and
    fallbacks, every rung on the operands' device. The attempt log
    rides back on `result.attempts`; a full-ladder failure raises
    `guard.RecoveryError`. A `guard.chaos.FaultPlan` passed as `fault`
    corrupts the FIRST attempt only — the recovery path always runs
    clean."""
    from repro_torch.guard import escalate
    return escalate.solve_with_policy(
        A, b, x0, tol=tol, policy=policy, max_iters=max_iters,
        mode=mode, device=device, fault=fault, precond=precond)


def power_iteration(A, v0=None, *, tol: float = 1e-6,
                    max_iters: int = 1000, mode: str = "dataflow",
                    device=None) -> SolverResult:
    """Dominant eigenpair via power iteration, wrapped as an Executable.
    The eigenvalue is `result.aux["eigenvalue"]`."""
    exe = _solver_executable("power_iteration", iterative.PowerIteration,
                             mode, device, max_iters)
    return exe.run(A=A, v0=v0, tol=tol)
