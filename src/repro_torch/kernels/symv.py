"""BLAS level-2 symv (y' = alpha S x + beta y with S symmetric, stored
in A's lower triangle) for Hopper, in CUDA C++ (`csrc/symv.cu`).

Replaces `repro/kernels/symv.py::symv` (its `pallas_call` at symv.py:63).
As there, only the lower triangle is referenced (the upper one may hold
NaN), the product accumulates in float32 with float32 alpha and beta
(symv.py:77-78), and the result is rounded once to A's dtype.

Bound on an H100 SXM: the HBM bytes of the lower triangle,
4 n(n+1)/2 for float32 (0.16 ms at n = 16384). The kernel reads the
triangle twice (csrc/symv.cu says why), so it sits near half its bound.
"""
from __future__ import annotations

import torch

from . import common, cuda
from .gemv import gemvt_plan


def symv_plan(n: int, itemsize: int):
    """(splits, rows per split) of the column blocks, as for gemvt."""
    return gemvt_plan(n, n, itemsize)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def symmetric_from_lower(a):
    """S in float32 from A's lower triangle. `tril` selects (it never
    multiplies), so a NaN in the upper triangle does not reach S."""
    af = a.float()
    return torch.tril(af) + torch.tril(af, -1).T


def symv_acc(a, x):
    """S x in float32: the anchor's product, before alpha and beta."""
    return symmetric_from_lower(a) @ x.float()


def symv_plain(alpha, a, x, beta, y):
    s = common.scalar_block([alpha, beta], a.device)
    return (s[0] * symv_acc(a, x) + s[1] * y.float()).to(a.dtype)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


@common.counted
def symv(alpha, a, x, beta, y):
    """y' = alpha S x + beta y, S the symmetric matrix in A's lower
    triangle; A (n, n), x and y (n,)."""
    m, n = common.check_matrix(a)
    if m != n:
        raise ValueError(f"symv needs a square matrix, got {tuple(a.shape)}")
    common.check_vectors(x, y)
    if x.shape[0] != n or x.dtype != a.dtype:
        raise ValueError(f"symv with A {tuple(a.shape)} {a.dtype} needs x "
                         f"and y of length {n} in that dtype, got "
                         f"{x.shape[0]} {x.dtype}")
    if not common.on_card(a, x, y):
        symv.plain_calls += 1
        return symv_plain(alpha, a, x, beta, y)
    for v in (x, y):
        if not v.is_contiguous():
            raise ValueError("the level-2 kernels take contiguous vectors")
    splits, rows = symv_plan(n, a.element_size())
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    work = torch.empty((1 + splits, n), dtype=torch.float32, device=a.device)
    scal = common.scalar_block([alpha, beta], a.device)
    cuda.launch("symv", "repro_symv", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal),
                n, rows, splits)
    symv.launches += 1
    symv.finish_launches += 1
    return out
