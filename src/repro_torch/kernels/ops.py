"""Public entry points for the port's kernels.

Each op launches its kernel on CUDA tensors (Triton for level 1, CUDA
C++ for gemv, gemvt, symv, ger, transpose, gemm, mha and
decode_attention) and runs its plain
PyTorch version on CPU tensors; `ref.py` holds the oracles with the
reference's semantics.
`axpydot_nodf` is the deliberately non-dataflow axpydot (two kernels, z
round-trips through HBM): the paper's "w/o DF" bar. `gesummv`, `atax`
and `bicgk` compose the level-2 kernels as `repro/kernels/ops.py:44-66`
does, except that Aᵀ v runs on `gemvt` instead of `gemv` over a
transposed copy of A: the same function, without the copy.
"""
from __future__ import annotations

import torch

from . import ref  # noqa: F401  (re-exported for convenience)
from .axpy import axpy, copy, rot, scal, vmul, waxpby
from .attention import mha
from .axpydot import axpydot
from .decode_attention import decode_attention
from .dot import asum, dot, iamax, nrm2
from .gemm import gemm, matmul
from .gemv import gemv, gemvt
from .ger import ger
from .symv import symv
from .transpose import transpose

__all__ = [
    "axpy", "scal", "waxpby", "copy", "vmul", "rot", "dot", "asum",
    "nrm2", "iamax", "axpydot", "axpydot_nodf", "gemv", "gemvt", "symv",
    "ger", "transpose", "gemm", "matmul", "gesummv", "atax", "bicgk",
    "mha", "decode_attention", "ref", "KERNELS",
]

# every counted kernel wrapper, by routine name (matmul launches gemm)
KERNELS = {f.__name__: f for f in (axpy, scal, waxpby, copy, vmul, rot,
                                    dot, asum, nrm2, iamax, axpydot, gemv,
                                    gemvt, symv, ger, transpose, gemm, mha,
                                    decode_attention)}


def axpydot_nodf(alpha, w, v, u):
    """Non-dataflow axpydot: z is materialized in HBM between the two
    routine kernels (the paper's 'w/o DF' bar)."""
    z = axpy(-alpha, v, w)   # z = w - alpha*v
    return dot(z, u)


def _zeros(n, like):
    return torch.zeros(n, dtype=like.dtype, device=like.device)


def gesummv(alpha, a, beta, b, x):
    """y = alpha A x + beta B x: the second gemv accumulates into the
    first one's y."""
    y1 = gemv(alpha, a, x, 0.0, _zeros(a.shape[0], a))
    return gemv(beta, b, x, 1.0, y1)


def atax(a, x):
    """y = Aᵀ (A x)."""
    ax = gemv(1.0, a, x, 0.0, _zeros(a.shape[0], a))
    return gemvt(1.0, a, ax, 0.0, _zeros(a.shape[1], a))


def bicgk(a, p, r):
    """q = A p ; s = Aᵀ r."""
    q = gemv(1.0, a, p, 0.0, _zeros(a.shape[0], a))
    s = gemvt(1.0, a, r, 0.0, _zeros(a.shape[1], a))
    return q, s
