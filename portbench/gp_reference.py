"""The benchmark's plain reference for the GP predictive solve: the
Matérn-3/2 kernel, the partial pivoted Cholesky preconditioner, its
Woodbury application and preconditioned CG over a panel of right-hand
sides. Plain PyTorch and `math`; it imports nothing of the program, and
takes from a run only the inputs the harness made and the answers it
judges.

A product with the (n, n) operator is taken a block of rows at a time,
each block cast to the working dtype (float64 for every number that
decides `correct`), so that a float64 product with the 16 GiB float32
operator needs 1 GiB at a time. Float32 products run with TF32 off;
`tf32=True`, on an operator rounded once by `tf32_copy`, rounds the
vector of each operator product to TF32 too (10 mantissa bits, as the
tensor cores do) and sums in float32: the control that decides whether
the comparison can see TF32.
"""
from __future__ import annotations

import contextlib
import math

import torch

# rows of the operator cast at a time (1 GiB of float64 at n = 65,536)
ROWS = 2048


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmul and cuDNN, and
    restored on exit."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 copy of `x` rounded to TF32, to nearest with ties away
    from zero (`cvt.rna`)."""
    out = x.detach().to(torch.float32, copy=True).contiguous()
    bits = out.view(torch.int32)
    bits.add_(0x1000).bitwise_and_(-0x2000)
    return out


def tf32_copy(A: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """A float32 copy of the operator rounded to TF32, a block of rows at
    a time: the operand `matmul(..., tf32=True)` takes."""
    out = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    for i in range(0, A.shape[0], rows):
        out[i:i + rows] = round_tf32(A[i:i + rows])
    return out


def matern32(X1: torch.Tensor, X2: torch.Tensor, lengthscale: float,
             outputscale: float) -> torch.Tensor:
    """k(x, x') = s² (1 + √3 r / ℓ) exp(−√3 r / ℓ), r = ‖x − x'‖, for
    every row pair of X1 and X2, in their dtype (Rasmussen & Williams
    2006, eq. 4.17). Distances from the differences, never from the
    Gram expansion, which loses the small ones."""
    r = torch.cdist(X1, X2, compute_mode="donot_use_mm_for_euclid_dist")
    a = (math.sqrt(3.0) / lengthscale) * r
    return outputscale * (1.0 + a) * torch.exp(-a)


def kernel_matrix(X: torch.Tensor, lengthscale: float, outputscale: float,
                  noise: float, dtype=torch.float32,
                  rows: int = ROWS) -> torch.Tensor:
    """K̂ = K + noise·I on X's device, each block of rows computed in
    float64 and rounded once to `dtype`."""
    n = X.shape[0]
    X64 = X.to(torch.float64)
    out = torch.empty(n, n, dtype=dtype, device=X.device)
    for i in range(0, n, rows):
        block = matern32(X64[i:i + rows], X64, lengthscale, outputscale)
        block.diagonal(offset=i).add_(noise)
        out[i:i + rows] = block.to(dtype)
        del block
    return out


def matmul(A: torch.Tensor, V: torch.Tensor, dtype=torch.float64,
           rows: int = ROWS, tf32: bool = False) -> torch.Tensor:
    """A V in `dtype`, A's rows cast a block at a time (V: (n,) or
    (n, m)); with `tf32`, V rounded to TF32 first and A taken as given,
    already rounded (`tf32_copy`), so that both operands are TF32 and
    the sums float32."""
    V = V.to(dtype)
    if tf32:
        V = round_tf32(V)
    out = torch.empty((A.shape[0],) + tuple(V.shape[1:]), dtype=dtype,
                      device=V.device)
    with no_tf32():
        for i in range(0, A.shape[0], rows):
            out[i:i + rows] = A[i:i + rows].to(dtype) @ V
    return out


def pivoted_cholesky(A: torch.Tensor, rank: int, shift: float,
                     dtype=torch.float64):
    """The rank-`rank` partial pivoted Cholesky factor L of A − shift·I
    in `dtype` (greedy: each step pivots on the largest remaining
    diagonal entry; GPyTorch's algorithm), and the pivots in order."""
    n = A.shape[0]
    d = A.diagonal().to(dtype) - shift
    L = torch.zeros(n, rank, dtype=dtype, device=A.device)
    pivots = []
    with no_tf32():
        for m in range(rank):
            p = int(torch.argmax(d))
            pivots.append(p)
            row = A[p].to(dtype).clone()
            row[p] -= shift
            if m:
                row -= L[:, :m] @ L[p, :m]
            col = row / math.sqrt(float(d[p]))
            L[:, m] = col
            d = d - col * col
    return L, pivots


def woodbury(L: torch.Tensor, shift: float) -> torch.Tensor:
    """W = L (shift·I + LᵀL)⁻¹, so that (L Lᵀ + shift·I)⁻¹ r =
    (r − W Lᵀ r) / shift; in L's dtype, the (k, k) system in float64."""
    L64 = L.to(torch.float64)
    k = L.shape[1]
    C = L64.T @ L64 + shift * torch.eye(k, dtype=torch.float64,
                                        device=L.device)
    return torch.linalg.solve(C, L64.T).T.to(L.dtype)


def precond_apply(L: torch.Tensor, W: torch.Tensor, shift: float,
                  R: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ + shift·I)⁻¹ R through Woodbury (R: (n,) or (n, m))."""
    with no_tf32():
        return (R - W @ (L.T @ R)) / shift


def pcg(A: torch.Tensor, B: torch.Tensor, L, W, shift: float, *,
        tol: float, max_iters: int, rows: int = ROWS, tf32: bool = False):
    """Preconditioned CG from x0 = 0 on each column of B (n, m) apart,
    in B's dtype, with no kernels and no fusion: every column stops at
    the first iteration whose recurrence residual meets ‖r‖ <= tol ‖b‖
    (the program's stop rule), and a stopped column is left as it is.
    `L` None runs plain CG. Returns (X, iterations a column, ‖r‖ a
    column by the recurrence)."""
    dtype = B.dtype

    def mv(V):
        return matmul(A, V, dtype, rows, tf32)

    def apply(R):
        return R if L is None else precond_apply(L, W, shift, R)

    X = torch.zeros_like(B)
    R = B - mv(X)
    bnorm = torch.linalg.vector_norm(B, dim=0)
    rnorm = torch.linalg.vector_norm(R, dim=0)
    Z = apply(R)
    P = Z.clone()
    rz = (R * Z).sum(0)
    iters = torch.zeros(B.shape[1], dtype=torch.int64, device=B.device)
    active = rnorm > tol * bnorm
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        Q = mv(P)
        alpha = torch.where(active, rz / (P * Q).sum(0),
                            torch.zeros_like(rz))
        X += alpha * P
        R -= alpha * Q
        Z = apply(R)
        rz_next = (R * Z).sum(0)
        P = torch.where(active, Z + (rz_next / rz) * P, P)
        rz = torch.where(active, rz_next, rz)
        iters += active.to(torch.int64)
        rnorm = torch.linalg.vector_norm(R, dim=0)
        active = active & (rnorm > tol * bnorm)
    return X, iters, rnorm
