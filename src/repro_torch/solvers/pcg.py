"""Preconditioned conjugate gradient as a JSON loop program, and the
partial pivoted Cholesky preconditioner it takes.

This is the solver GPyTorch runs for an exact Gaussian process's solves
with K + σ²I (Gardner et al., NeurIPS 2018, arXiv 1809.11165): CG
preconditioned by P = L Lᵀ + σ²I, with L a rank-k partial pivoted
Cholesky factor of the kernel matrix K without its noise. P is applied
through the Woodbury identity,

    P⁻¹ r = (r − W (Lᵀ r)) / σ²,    W = L (σ²I + LᵀL)⁻¹,

so an application reads the two tall (n, k) factors once each: a gemvt
(t = Lᵀ r) and a gemv-anchored group (z = −W t / σ² + r / σ², with
rᵀz folded in), both registry routines on the generated-kernel path.

`PCG_LOOP` keeps CG's stop rule (‖r‖ / ‖b‖ under `tol`) and its guards
(with a wider stagnation window: PCG's residual norm is not monotone);
its operands are CG's plus the preconditioner's L, W and shift σ². The
module stands beside `specs.py`, which holds the reference package's
solver specs name for name.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs

from .specs import CG_MATVEC, CG_PUPDATE, CG_UPDATE, NRM2, RESIDUAL

# z = P⁻¹ r through Woodbury ; rz = rᵀ z
# (t = Lᵀ r is a gemvt over the tall factor: its (k,) output feeds the
#  gemv's reduction-axis operand, which the planner never absorbs; the
#  gemv anchors z and streams it into the dot, so z reaches HBM once and
#  rᵀz needs no second pass. `t0` is a (k,) vector already in the
#  environment, multiplied by beta = 0.)
PCG_PRECOND = {
    "name": "pcg_precond",
    "routines": [
        {"blas": "gemvt", "name": "proj",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "L", "x": "r", "y": "t0"},
         "connections": {"out": "corr.x"}},
        {"blas": "gemv", "name": "corr",
         "scalars": {"alpha": {"input": "neg_inv_shift"},
                     "beta": {"input": "inv_shift"}},
         "inputs": {"A": "W", "y": "r"},
         "connections": {"out": "rz.x"}, "outputs": {"out": "z"}},
        {"blas": "dot", "name": "rz", "inputs": {"y": "r"},
         "outputs": {"out": "rz"}},
    ],
}

PCG_LOOP = {
    "name": "pcg",
    "dtype": "float32",
    "operands": {"A": "matrix", "b": "vector", "x0": "vector",
                 "L": "matrix", "W": "matrix", "shift": "scalar"},
    "setup": [
        {"program": NRM2, "inputs": {"x": "b"},
         "outputs": {"norm": "bnorm"}},
        {"program": RESIDUAL, "inputs": {"x": "x0"},
         "outputs": {"r": "r0", "rnorm": "rnorm0"}},
        {"read": {"name": "t0", "from": "L", "slot": 0}},   # a (k,) row
        {"let": {"inv_shift": "1 / shift",
                 "neg_inv_shift": "-inv_shift"}},
        {"program": PCG_PRECOND, "inputs": {"r": "r0"},
         "outputs": {"z": "z0", "rz": "rz0"}},
    ],
    "iterate": {
        "state": {
            "x": {"init": "x0"},
            "r": {"init": "r0"},
            "p": {"init": "z0"},
            "rz": {"init": "rz0", "kind": "scalar"},
        },
        "body": [
            {"program": CG_MATVEC},                      # q = A p ; pq
            {"let": {"alpha": "rz / pq",
                     "neg_alpha": "-alpha"}},
            {"program": CG_UPDATE},          # x', r', ‖r'‖ (fused)
            {"program": PCG_PRECOND, "inputs": {"r": "r_next"},
             "outputs": {"rz": "rz_next"}},  # z' = P⁻¹ r' ; r'ᵀz'
            {"let": {"beta": "rz_next / rz"}},
            {"program": CG_PUPDATE, "inputs": {"r": "z"}},   # p' = z' + βp
        ],
        "feedback": {
            "x": "x_next", "r": "r_next", "p": "p_next",
            "rz": "rz_next",
        },
        # GPyTorch's defaults for predictions: eval_cg_tolerance 0.01,
        # max_cg_iterations 1000
        "while": {"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
                  "rtol": 1e-2, "max_iters": 1000},
        # CG's guards. PCG's residual 2-norm is not monotone: over 40
        # sound solves at n = 65,536 it rose up to 56x over ‖r0‖ and
        # went up to 65 iterations without a new best, so CG's
        # stagnation window of 50 would stop them; 200 still stops a
        # solve that makes no progress long before max_iters
        "guards": {
            "nonfinite": ["x_next"],
            "breakdown": [{"value": "pq", "below": 1e-30}],
            "divergence": {"factor": 1e4},
            "stagnation": {"window": 200},
        },
        "solution": {"x": "x"},
    },
}


@dataclasses.dataclass(frozen=True)
class PivotedCholesky:
    """A rank-k preconditioner P = L Lᵀ + shift·I for an operator whose
    shift is its noise: L the partial pivoted Cholesky factor of the
    operator less the shift, W = L (shift·I + LᵀL)⁻¹ for its Woodbury
    application, both (n, k) float32 on the operator's device; `pivots`
    the rows chosen, in order; `shift` a 0-d float32 there too."""
    L: torch.Tensor
    W: torch.Tensor
    pivots: torch.Tensor
    shift: torch.Tensor

    @property
    def rank(self) -> int:
        return int(self.L.shape[1])

    def operands(self) -> dict:
        """The preconditioner's operands of `PCG_LOOP`."""
        return {"L": self.L, "W": self.W, "shift": self.shift}


def pivoted_cholesky(A: torch.Tensor, rank: int,
                     shift: float) -> PivotedCholesky:
    """The rank-`rank` partial pivoted Cholesky factor of A − shift·I,
    as GPyTorch factors a kernel matrix without its noise, and the
    Woodbury factor of P = L Lᵀ + shift·I. Runs on A's device: each step
    takes the largest remaining diagonal entry as its pivot, reads that
    row of A, and subtracts the columns found so far (one gemv over the
    tall factor); no step reads the device's values on the host. The
    small (k, k) system shift·I + LᵀL is formed and solved in float64.
    A is square and symmetric; only its pivots' rows and its diagonal
    are read."""
    n = A.shape[0]
    k = int(rank)
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"pivoted_cholesky: A must be square, got "
                         f"shape {tuple(A.shape)}")
    if not 0 < k <= n:
        raise ValueError(f"pivoted_cholesky: rank must lie in [1, {n}], "
                         f"got {rank}")
    if not shift > 0:
        raise ValueError(f"pivoted_cholesky: shift must be positive, got "
                         f"{shift}")
    dev = A.device
    with obs.span("precond.build", rank=k, n=n):
        d = A.diagonal().to(torch.float32) - float(shift)
        L = torch.zeros(n, k, dtype=torch.float32, device=dev)
        pivots = torch.empty(k, dtype=torch.int64, device=dev)
        for m in range(k):
            p = torch.argmax(d).reshape(1)
            pivots[m:m + 1] = p
            row = A.index_select(0, p).reshape(n).to(torch.float32)
            row = row.index_add(0, p, torch.full((1,), -float(shift),
                                                 device=dev))
            if m:
                row = row - L[:, :m] @ L.index_select(0, p).reshape(k)[:m]
            col = row / torch.sqrt(d.index_select(0, p))
            L[:, m] = col
            d = d - col * col
        L64 = L.to(torch.float64)
        C = L64.T @ L64 + float(shift) * torch.eye(k, dtype=torch.float64,
                                                   device=dev)
        W = torch.linalg.solve(C, L64.T).T.to(torch.float32).contiguous()
        return PivotedCholesky(
            L=L, W=W, pivots=pivots,
            shift=torch.full((), float(shift), dtype=torch.float32,
                             device=dev))
