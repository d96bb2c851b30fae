"""BLAS level-2 ger (A' = alpha x yᵀ + A), the rank-1 update, for
Hopper, in CUDA C++ (`csrc/ger.cu`).

Replaces `repro/kernels/ger.py::ger` (its `pallas_call` at ger.py:38)
and matches that kernel rather than `ref.ger`: x, y and A are read as
float32, alpha is float32, `(alpha x_i) y_j + A_ij` is computed in
float32 in that order and rounded once to A's dtype (ger.py:21-25).
The result is a new tensor; A is never written, since a program may
read it again.

Bound on an H100 SXM: HBM bytes, 2 · itemsize · m · n plus the vectors
(0.641 ms for a 16384 x 16384 float32 A). The kernel's tiles are
described in csrc/ger.cu.
"""
from __future__ import annotations

import torch

from . import common, cuda

# columns of one block's tile: 256 threads of 16 bytes each
_TILE_BYTES = 256 * 16
_MAX_GRID_Y = 65535




def footprint(itemsize: int):
    """Shared memory per block: none (x and y come through the
    read-only cache); no tuning knob."""
    return (common.Footprint("ger_kernel", common.STATIC_SLACK),)


def ger_plain(alpha, x, y, a):
    """The kernel's float32 arithmetic, in its order, rounded once."""
    s = common.scalar_block([alpha], a.device)[0]
    return ((s * x.float())[:, None] * y.float()[None, :]
            + a.float()).to(a.dtype)


def _check(x, y, a):
    m, n = common.check_matrix(a)
    common.check_vectors(x, same_dtype=False)
    common.check_vectors(y, same_dtype=False)
    if x.shape[0] != m or y.shape[0] != n:
        raise ValueError(f"x yᵀ + A with A {tuple(a.shape)} needs x of "
                         f"length {m} and y of length {n}, got "
                         f"{x.shape[0]} and {y.shape[0]}")
    for v in (x, y):
        if v.dtype != a.dtype:
            raise ValueError(f"operand dtypes disagree: A {a.dtype}, "
                             f"vector {v.dtype}")
    return m, n


@common.counted
def ger(alpha, x, y, a):
    """A' = alpha x yᵀ + A for x (m,), y (n,), A (m, n): a new tensor
    in A's dtype."""
    m, n = _check(x, y, a)
    if not common.on_card(x, y, a):
        ger.plain_calls += 1
        return ger_plain(alpha, x, y, a)
    if common.cdiv(n * a.element_size(), _TILE_BYTES) > _MAX_GRID_Y:
        raise ValueError(f"ger takes at most {_MAX_GRID_Y} column tiles "
                         f"of {_TILE_BYTES} bytes; A has {n} columns")
    for v in (x, y):
        if not v.is_contiguous():
            raise ValueError("the level-2 kernels take contiguous vectors")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    scal = common.scalar_block([alpha], a.device)
    cuda.launch("ger", "repro_ger", a, cuda.ptr(x), cuda.ptr(y),
                cuda.ptr(a), cuda.ptr(out), cuda.ptr(scal), m, n)
    ger.launches += 1
    return out
