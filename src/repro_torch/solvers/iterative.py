"""Class-based iterative solvers over the port's dataflow programs.

Every linear-algebra statement runs through registry routines composed
in ProgramSpec JSON (`solvers.specs`), lowered by the fusion planner and
the kernel generators, so each iteration launches the port's kernels:

  CG, Jacobi,     — hand-written counterparts of the JSON loop specs
  BiCGStab          (`specs.CG_LOOP`, `specs.JACOBI_LOOP`,
                    `specs.BICGSTAB_LOOP`) over the same stage programs;
                    they stay as the parity oracles the loop specs are
                    tested against. `repro_torch.blas.cg/jacobi/bicgstab`
                    run the spec path.
  PowerIteration  — its Rayleigh-quotient metric is beyond the loop
                    grammar; `repro_torch.blas.power_iteration` wraps it.

Each solver runs on the CUDA card unless built with `device="cpu"`, and
raises when there is no card and no device was named. The host loop of
`driver.SolverProgram` drives it: one read of the stop test per
iteration, everything else on the device.
"""
from __future__ import annotations

import torch

from . import specs
from .driver import BATCHED, SolverProgram, SolverResult, _f32, _sdiv, _TINY


class _LinearSolver(SolverProgram):
    """Shared Ax=b boilerplate: operand packing and the ‖b‖ scale."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._resid = self._program(specs.RESIDUAL)
        self._nrm = self._program(specs.NRM2)

    def solve(self, A, b, x0=None, *, tol: float = 1e-6) -> SolverResult:
        if x0 is None:
            x0 = torch.zeros_like(b)
        return self._run({"A": A, "b": b, "x0": x0}, tol)

    def solve_batched(self, A, B, X0=None, *,
                      tol: float = 1e-6) -> SolverResult:
        """The reference vmaps its jitted solve over the rows of B; the
        port's batched solve is not written yet."""
        raise NotImplementedError(
            f"{type(self).__name__}.solve_batched is not ported yet "
            f"({BATCHED}); call solve() once per right-hand side")

    def _residual(self, A, b, x):
        o = self._resid(A=A, b=b, x=x)
        return o["r"], o["rnorm"]

    def _scale(self, b):
        return self._nrm(x=b)["norm"]


class CG(_LinearSolver):
    """Conjugate gradient for SPD systems (hand-written counterpart of
    the JSON loop spec `specs.CG_LOOP`)."""

    name = "cg"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._mv = self._program(specs.CG_MATVEC)
        self._upd = self._program(specs.CG_UPDATE)
        self._pupd = self._program(specs.CG_PUPDATE)

    def _init_state(self, ops_):
        r, rnorm = self._residual(ops_["A"], ops_["b"], ops_["x0"])
        state = dict(x=ops_["x0"], r=r, p=r, rz=rnorm * rnorm)
        return state, rnorm, self._scale(ops_["b"])

    def _step(self, ops_, st, threshold):
        o1 = self._mv(A=ops_["A"], p=st["p"])
        alpha = _sdiv(st["rz"], o1["pq"])
        o2 = self._upd(alpha=alpha, neg_alpha=-alpha, p=st["p"],
                       x=st["x"], q=o1["q"], r=st["r"])
        rz_next = o2["rnorm"] * o2["rnorm"]
        beta = _sdiv(rz_next, st["rz"])
        o3 = self._pupd(beta=beta, r=o2["r_next"], p=st["p"])
        state = dict(x=o2["x_next"], r=o2["r_next"], p=o3["p_next"],
                     rz=rz_next)
        return state, o2["rnorm"]

    def _solution(self, st):
        return {"x": st["x"]}


class BiCGStab(_LinearSolver):
    """Stabilized bi-conjugate gradient for general square systems.

    Implements the classic ‖s‖-based early exit: after s = r - alpha v,
    if ‖s‖ is already below the convergence threshold the step finishes
    with x += alpha p, skipping the second matvec and the omega stage,
    and reports ‖s‖ as the residual (r' = s exactly in that branch).
    The reference takes the branch under `lax.cond` on the device; the
    port reads the predicate on the host and runs one branch, as the
    loop driver's `cond` stage does, which costs one more host wait per
    iteration than CG.
    """

    name = "bicgstab"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._mv1 = self._program(specs.BICG_MATVEC1)
        self._sup = self._program(specs.BICG_SUPDATE)
        self._xh = self._program(specs.BICG_XHALF)
        self._mv2 = self._program(specs.BICG_MATVEC2)
        self._xrup = self._program(specs.BICG_XRUPDATE)
        self._pupd = self._program(specs.BICG_PUPDATE)

    def _init_state(self, ops_):
        r, rnorm = self._residual(ops_["A"], ops_["b"], ops_["x0"])
        state = dict(x=ops_["x0"], r=r, rhat=r, p=r, rho=rnorm * rnorm)
        return state, rnorm, self._scale(ops_["b"])

    def _step(self, ops_, st, threshold):
        A = ops_["A"]
        o1 = self._mv1(A=A, p=st["p"], rhat=st["rhat"])
        alpha = _sdiv(st["rho"], o1["rv"])
        o2 = self._sup(neg_alpha=-alpha, v=o1["v"], r=st["r"])
        s, snorm = o2["s"], o2["snorm"]
        if bool(snorm <= threshold):
            # ‖s‖ already converged: x' = x + alpha p, r' = s; p and rho
            # carry over unchanged (the loop exits on snorm)
            o = self._xh(alpha=alpha, p=st["p"], x=st["x"])
            state = dict(x=o["x_half"], r=s, rhat=st["rhat"], p=st["p"],
                         rho=st["rho"])
            return state, snorm
        o3 = self._mv2(A=A, s=s)
        omega = _sdiv(o3["ts"], o3["tt"])
        o4 = self._xrup(alpha=alpha, omega=omega, neg_omega=-omega,
                        p=st["p"], x=st["x"], s=s, t=o3["t"],
                        rhat=st["rhat"])
        beta = _sdiv(o4["rho_next"], st["rho"]) * _sdiv(alpha, omega)
        o5 = self._pupd(neg_omega=-omega, v=o1["v"], p=st["p"], beta=beta,
                        r=o4["r_next"])
        state = dict(x=o4["x_next"], r=o4["r_next"], rhat=st["rhat"],
                     p=o5["p_next"], rho=o4["rho_next"])
        return state, o4["rnorm"]

    def _solution(self, st):
        return {"x": st["x"]}


class Jacobi(_LinearSolver):
    """Weighted Jacobi: x' = x + omega D⁻¹ (b - A x). With
    `richardson=True` the diagonal scaling is skipped (D⁻¹ = I).

    Hand-written counterpart of the JSON loop spec `specs.JACOBI_LOOP`.
    Each iteration runs two dataflow programs: the fused vmul -> axpy
    update, then RESIDUAL (gemv + fused vsub -> nrm2) on the updated
    iterate, so the residual and history always describe the returned x.
    """

    name = "jacobi"

    def __init__(self, *, omega: float = 1.0, richardson: bool = False,
                 **kw):
        super().__init__(**kw)
        self.omega = float(omega)
        self.richardson = richardson
        self._upd = self._program(specs.JACOBI_UPDATE)

    def _init_state(self, ops_):
        r, rnorm = self._residual(ops_["A"], ops_["b"], ops_["x0"])
        if self.richardson:
            dinv = torch.ones_like(ops_["b"])
        else:
            dinv = jacobi_dinv(ops_["A"], ops_["b"].dtype)
        state = dict(x=ops_["x0"], r=r, dinv=dinv)
        return state, rnorm, self._scale(ops_["b"])

    def _step(self, ops_, st, threshold):
        o = self._upd(r=st["r"], dinv=st["dinv"], x=st["x"],
                      omega=_f32(self.omega, self.device))
        # residual of the updated iterate, so the reported residual and
        # history always belong to the returned x
        r_next, rnorm = self._residual(ops_["A"], ops_["b"], o["x_next"])
        return dict(x=o["x_next"], r=r_next, dinv=st["dinv"]), rnorm

    def _solution(self, st):
        return {"x": st["x"]}


class PowerIteration(SolverProgram):
    """Dominant eigenpair via power iteration. The convergence metric is
    the relative Rayleigh-quotient change |λ_k - λ_{k-1}| / |λ_k|."""

    name = "power"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._stp = self._program(specs.POWER_STEP)
        self._nrmlz = self._program(specs.NORMALIZE)
        self._nrm = self._program(specs.NRM2)

    def solve(self, A, v0=None, *, tol: float = 1e-6) -> SolverResult:
        if v0 is None:
            n = A.shape[0]
            # deterministic non-degenerate start
            v0 = torch.cos(torch.arange(n, dtype=A.dtype, device=A.device)
                           * 0.7) + 0.1
        return self._run({"A": A, "v0": v0}, tol)

    def _init_state(self, ops_):
        norm = self._nrm(x=ops_["v0"])["norm"]
        v = self._nrmlz(inv_norm=_sdiv(1.0, norm), av=ops_["v0"])["v_next"]
        state = dict(v=v, lam=_f32(0.0, self.device))
        return state, float("inf"), 1.0

    def _step(self, ops_, st, threshold):
        o = self._stp(A=ops_["A"], v=st["v"])
        lam = o["lambda"]
        v_next = self._nrmlz(inv_norm=_sdiv(1.0, o["norm"]),
                             av=o["av"])["v_next"]
        res = (lam - st["lam"]).abs() / torch.clamp_min(lam.abs(), _TINY)
        return dict(v=v_next, lam=lam), res

    def _solution(self, st):
        return {"x": st["v"], "eigenvalue": st["lam"]}


# ---------------------------------------------------------------------------
# Functional convenience wrappers
# ---------------------------------------------------------------------------


def jacobi_dinv(A, dtype=None):
    """Inverse-diagonal operand for Jacobi (zero diagonals pass through
    unscaled)."""
    diag = torch.diagonal(A)
    safe = torch.where(diag == 0, 1.0, diag)
    dinv = torch.where(diag == 0, 1.0, 1.0 / safe)
    return dinv.to(dtype or A.dtype)


def cg(A, b, x0=None, *, tol=1e-6, max_iters=500, mode="dataflow",
       device=None) -> SolverResult:
    return CG(mode=mode, max_iters=max_iters,
              device=device).solve(A, b, x0, tol=tol)


def bicgstab(A, b, x0=None, *, tol=1e-6, max_iters=500, mode="dataflow",
             device=None) -> SolverResult:
    return BiCGStab(mode=mode, max_iters=max_iters,
                    device=device).solve(A, b, x0, tol=tol)


def jacobi(A, b, x0=None, *, tol=1e-6, max_iters=1000, omega=1.0,
           richardson=False, mode="dataflow", device=None) -> SolverResult:
    return Jacobi(mode=mode, max_iters=max_iters, omega=omega,
                  richardson=richardson,
                  device=device).solve(A, b, x0, tol=tol)


def power_iteration(A, v0=None, *, tol=1e-6, max_iters=1000,
                    mode="dataflow", device=None) -> SolverResult:
    return PowerIteration(mode=mode, max_iters=max_iters,
                          device=device).solve(A, v0, tol=tol)
