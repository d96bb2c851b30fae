"""Graceful solver degradation: the host-side escalation driver.

A guarded solve returns a `guard.status` code instead of just a
converged flag. This module reacts to failure codes with an ordered
fallback ladder:

    retry-with-restart  ->  switch solver (CG -> BiCGStab -> GMRES)
        ->  float64 dense direct solve (last resort)

A matrix right-hand side (``b.ndim == 2``, one column per system) is
handled by the same ladder with a panel-capable default chain
(``block_cg`` -> float64 dense direct, which solves every column).
With a preconditioner (``precond=``, a `solvers.pcg.PivotedCholesky`)
and no policy, preconditioned CG is the first rung and the default
chain follows it (``pcg`` -> CG -> BiCGStab -> GMRES -> float64 dense
direct); a ``pcg`` rung needs one.

`solve_with_policy` runs the ladder under an `EscalationPolicy`:
bounded attempts, optional backoff between rungs, a
`ft.StragglerWatchdog` around each attempt's wall clock, and a
`guard.*` obs event/counter per attempt. The attempt log rides back on
`SolverResult.attempts`; if every rung fails the driver raises
`RecoveryError` carrying the same log.

Every rung runs on the operands' device: the iterative rungs through
the `blas` solver functions on `device` (the CUDA card unless
``device="cpu"``), the last rung as `torch.linalg.solve_ex` in float64
where A and b lie. A rung never moves to the CPU. The host reads each
attempt's status, iterations and residual once, and once per retry
whether the last iterate is finite (its warm start).

A `chaos.FaultPlan` passed in applies to the FIRST attempt only —
retries and fallbacks always run clean compiles, which is what lets
the chaos drill demonstrate recovery.

All `repro_torch.blas` / `repro_torch.solvers` imports are
function-local: `solvers.driver` imports `repro_torch.guard`, so a
top-level import here would be circular.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

from repro_torch import obs
from repro_torch.guard import status as ST


class RecoveryError(RuntimeError):
    """Every rung of the escalation ladder failed. `attempts` holds
    the full `Attempt` log for the post-mortem."""

    def __init__(self, message: str, attempts: list):
        super().__init__(message)
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One rung of the escalation ladder, as actually executed."""
    solver: str          # "cg" | "bicgstab" | "gmres" | "dense_f64" ...
    action: str          # "initial" | "retry" | "switch" | "escalate_f64"
    status: int          # guard.status code
    status_name: str
    iterations: int
    residual: float
    duration_s: float
    straggler: bool = False


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """How far the driver may degrade before giving up.

    chain          ordered iterative solvers to try (first = preferred)
    retry_restart  retry the first solver once, warm-started from its
                   last finite iterate, before switching solvers
    max_attempts   hard cap on total attempts (f64 rung included)
    backoff_s      sleep backoff_s * attempt_index between rungs
    escalate_f64   allow the final float64 dense direct solve
    straggler_threshold  StragglerWatchdog threshold (x rolling median)
    """
    chain: Tuple[str, ...] = ("cg", "bicgstab", "gmres")
    retry_restart: bool = True
    max_attempts: int = 6
    backoff_s: float = 0.0
    escalate_f64: bool = True
    straggler_threshold: float = 4.0

    def __post_init__(self):
        if not self.chain:
            raise ValueError(
                "EscalationPolicy.chain must name at least one solver")
        if self.max_attempts < 1:
            raise ValueError("EscalationPolicy.max_attempts must be >= 1")
        known = {"cg", "bicgstab", "gmres", "jacobi", "block_cg", "pcg"}
        bad = [s for s in self.chain if s not in known]
        if bad:
            raise ValueError(
                f"EscalationPolicy.chain has unknown solvers {bad}; "
                f"known: {sorted(known)}")


# the default chain of a solve given a preconditioner: PCG, then the
# default chain
PRECOND_CHAIN = ("pcg",) + EscalationPolicy.chain


def _ladder(policy: EscalationPolicy) -> list:
    rungs = [(policy.chain[0], "initial")]
    if policy.retry_restart:
        rungs.append((policy.chain[0], "retry"))
    rungs.extend((s, "switch") for s in policy.chain[1:])
    return rungs


def _run_iterative(solver, A, b, x0, *, tol, max_iters, mode, device,
                   fault, precond=None):
    """One clean (or first-attempt faulted) iterative solve through
    the blas convenience layer."""
    import torch

    from repro_torch.blas import solvers as bs

    if fault is None:
        if solver == "gmres":
            return bs.gmres(A, b, x0, tol=tol, mode=mode, device=device)
        if solver == "pcg":
            return bs.pcg(A, b, x0, precond=precond, tol=tol,
                          max_iters=max_iters, mode=mode, device=device)
        fn = {"cg": bs.cg, "bicgstab": bs.bicgstab,
              "jacobi": bs.jacobi, "block_cg": bs.block_cg}[solver]
        return fn(A, b, x0, tol=tol, max_iters=max_iters, mode=mode,
                  device=device)

    # faulted attempt: a fresh compile through the fault-aware path —
    # never the memoized clean executables, never the lowering cache
    from repro_torch.blas import executable as bexe
    from repro_torch.solvers import pcg, specs

    extra = {}
    if solver == "gmres":
        raw, kw = specs.gmres_loop(20), {}
    elif solver == "pcg":
        raw, kw = pcg.PCG_LOOP, {"max_iters": max_iters}
        extra = precond.operands()
    elif solver == "cg":
        raw, kw = specs.CG_LOOP, {"max_iters": max_iters}
    elif solver == "bicgstab":
        raw, kw = specs.BICGSTAB_LOOP, {"max_iters": max_iters}
    elif solver == "block_cg":
        raw, kw = specs.BLOCK_CG_LOOP, {"max_iters": max_iters}
    else:
        raise ValueError(
            f"fault injection supports cg/pcg/bicgstab/gmres/block_cg, "
            f"not {solver!r}")
    exe = bexe.compile(raw, mode=mode, device=device, fault=fault, **kw)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if solver == "block_cg":
        return exe.run(A=A, B=b, x0=x0, tol=tol)
    return exe.run(A=A, b=b, x0=x0, tol=tol, **extra)


def _dense_f64(A, b, tol):
    """Last-resort escalation: a float64 dense direct solve on the
    operands' device. A singular A (nonzero `info`) gives NaN, as the
    reference's LinAlgError branch does; the accept test is the
    reference's. The solution stays in float64."""
    import torch

    from repro_torch.solvers.driver import SolverResult

    A64 = A.to(torch.float64)
    b64 = b.to(torch.float64)
    x, info = torch.linalg.solve_ex(A64, b64)
    if int(info) != 0:
        x = torch.full_like(b64, float("nan"))
    res = float(torch.linalg.vector_norm(b64 - A64 @ x))
    scale = max(float(torch.linalg.vector_norm(b64)), 1.0)
    ok = math.isfinite(res) and res <= max(tol, 1e-8) * scale * 1e3
    code = ST.CONVERGED if ok else ST.NONFINITE
    dev = b.device
    return SolverResult(
        x=x, iterations=torch.ones((), dtype=torch.int32, device=dev),
        residual=torch.full((), res, dtype=torch.float64, device=dev),
        history=torch.full((1,), res, dtype=torch.float64, device=dev),
        converged=torch.full((), ok, dtype=torch.bool, device=dev),
        status=torch.full((), code, dtype=torch.int8, device=dev),
        aux={"method": "dense_f64"})


def _status_code(res) -> int:
    if res.status is not None:
        return int(res.status)
    return ST.CONVERGED if bool(res.converged) else ST.MAX_ITERS


def solve_with_policy(A, b, x0=None, *, tol: float = 1e-6,
                      policy: Optional[EscalationPolicy] = None,
                      max_iters: int = 500, mode: str = "dataflow",
                      device=None, fault=None, precond=None):
    """Solve Ax=b, degrading gracefully on guard-detected failure.

    Returns the first converged `SolverResult` with the attempt log
    attached as `.attempts`; raises `RecoveryError` if the whole
    ladder fails. See the module docstring for the rung order."""
    import torch

    from repro_torch.ft.watchdog import StragglerWatchdog

    # A matrix RHS (one column per system) needs panel-capable rungs:
    # block-CG first, then the dense f64 rung (which solves a 2-D b
    # column by column). The vector chain stays the default.
    panel = getattr(b, "ndim", 1) == 2
    if precond is not None and panel:
        raise ValueError("a preconditioner applies to a vector right-hand "
                         "side; PCG has no panel form")
    if policy is None:
        policy = (EscalationPolicy(chain=("block_cg",)) if panel
                  else EscalationPolicy(chain=PRECOND_CHAIN)
                  if precond is not None else EscalationPolicy())
    if precond is None and "pcg" in policy.chain:
        raise ValueError("the chain has a 'pcg' rung, which needs a "
                         "preconditioner (precond=)")
    if panel:
        bad = [s for s in policy.chain if s != "block_cg"]
        if bad:
            raise ValueError(
                f"matrix right-hand sides need panel-capable solvers; "
                f"chain has {bad} (only 'block_cg' handles a 2-D b)")
    watchdog = StragglerWatchdog(threshold=policy.straggler_threshold,
                                 min_samples=2)
    attempts: list = []

    def record(solver, action, res, dur):
        code = _status_code(res)
        slow = watchdog.record(len(attempts), dur)
        att = Attempt(
            solver=solver, action=action, status=code,
            status_name=ST.status_name(code),
            iterations=int(res.iterations),
            residual=float(res.residual),
            duration_s=dur, straggler=slow)
        attempts.append(att)
        obs.event("guard.attempt", solver=solver, action=action,
                  status=att.status_name, iterations=att.iterations,
                  residual=att.residual,
                  duration_s=round(dur, 6), straggler=slow)
        obs.counter(f"guard.attempts.{att.status_name.lower()}")
        if slow:
            obs.counter("guard.stragglers")
        return att, code, res

    def finish(res):
        res.attempts = list(attempts)
        if len(attempts) > 1:
            obs.counter("guard.recovered")
            obs.event("guard.recovered",
                      solver=attempts[-1].solver,
                      action=attempts[-1].action,
                      attempts=len(attempts))
        return res

    last_x = None
    for solver, action in _ladder(policy):
        if len(attempts) >= policy.max_attempts:
            break
        if attempts and policy.backoff_s:
            time.sleep(min(policy.backoff_s * len(attempts), 2.0))
        # retry-with-restart warm-starts from the last finite iterate;
        # a solver switch starts fresh from the caller's x0
        start = x0
        if action == "retry" and last_x is not None \
                and bool(torch.isfinite(last_x).all()):
            start = last_x
        t0 = time.perf_counter()
        res = _run_iterative(
            solver, A, b, start, tol=tol, max_iters=max_iters,
            mode=mode, device=device,
            fault=fault if not attempts else None, precond=precond)
        _, code, res = record(solver, action, res,
                              time.perf_counter() - t0)
        if code == ST.CONVERGED:
            return finish(res)
        last_x = res.x

    if policy.escalate_f64 and len(attempts) < policy.max_attempts:
        if policy.backoff_s:
            time.sleep(min(policy.backoff_s * len(attempts), 2.0))
        t0 = time.perf_counter()
        res = _dense_f64(A, b, tol)
        _, code, res = record("dense_f64", "escalate_f64", res,
                              time.perf_counter() - t0)
        if code == ST.CONVERGED:
            return finish(res)

    obs.counter("guard.recovery_failed")
    raise RecoveryError(
        f"all {len(attempts)} escalation attempts failed "
        f"(last: {attempts[-1].solver} -> {attempts[-1].status_name})"
        if attempts else "escalation ladder was empty",
        attempts)
