"""BLAS level-2 gemv (y' = alpha A x + beta y) and gemvt
(y' = alpha Aᵀ x + beta y) for Hopper, in CUDA C++ (`csrc/gemv.cu`).

Replaces `repro/kernels/gemv.py::gemv` (its `pallas_call` at gemv.py:60)
and `::gemvt` (:112). As there, the products accumulate in float32,
alpha and beta are float32 (gemv.py:73-74: not rounded to the vector
dtype, unlike axpy), `beta * y` is computed even when beta is 0, and the
result is rounded once to A's dtype.

Bound on an H100 SXM: HBM bytes, 4(mn + n + 2m) for a float32 gemv
(0.32 ms at 16384 x 16384). The kernel design and its split of the
reduction axis are described in csrc/gemv.cu; the split count and
the float32 scratch for the partials are chosen here.
"""
from __future__ import annotations

import torch

from . import common, cuda

# blocks that fill the card once: 132 SMs x 8 resident 256-thread blocks
TARGET_BLOCKS = 132 * 8
ROWS_PER_BLOCK = 8     # gemv: one warp per row
THREADS = 256
MIN_ROWS_PER_SPLIT = 64


def gemv_plan(m: int, n: int, itemsize: int):
    """(splits, columns per split) of a gemv launch. One split when the
    rows alone fill the card; otherwise the columns are cut into chunks
    of whole warp-wide 16-byte steps."""
    row_blocks = common.cdiv(m, ROWS_PER_BLOCK)
    if row_blocks >= TARGET_BLOCKS:
        return 1, n
    step = 32 * (16 // itemsize)
    want = common.cdiv(TARGET_BLOCKS, row_blocks)
    chunk = max(step, common.cdiv(common.cdiv(n, want), step) * step)
    return common.cdiv(n, chunk), chunk


def gemvt_plan(m: int, n: int, itemsize: int):
    """(splits, rows per split) of a gemvt launch: the rows are cut when
    the column tiles alone do not fill the card."""
    col_tiles = common.cdiv(n, THREADS * (16 // itemsize))
    want = common.cdiv(TARGET_BLOCKS, col_tiles)
    splits = max(1, min(want, m // MIN_ROWS_PER_SPLIT))
    rows = common.cdiv(m, splits)
    return common.cdiv(m, rows), rows


# ---------------------------------------------------------------------------
# Plain versions (float32 accumulation, one rounding to A's dtype)
# ---------------------------------------------------------------------------


def gemv_acc(a, x):
    """A x in float32: the anchor's product, before alpha and beta."""
    return a.float() @ x.float()


def gemvt_acc(a, x):
    """Aᵀ x in float32 (a transposed view, no copy of A)."""
    return a.float().T @ x.float()


def _epilogue(acc, alpha, beta, y, dtype):
    s = common.scalar_block([alpha, beta], acc.device)
    return (s[0] * acc + s[1] * y.float()).to(dtype)


def gemv_plain(alpha, a, x, beta, y):
    return _epilogue(gemv_acc(a, x), alpha, beta, y, a.dtype)


def gemvt_plain(alpha, a, x, beta, y):
    return _epilogue(gemvt_acc(a, x), alpha, beta, y, a.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _check(a, x, y, transposed):
    m, n = common.check_matrix(a)
    xlen, ylen = (m, n) if transposed else (n, m)
    common.check_vectors(x, same_dtype=False)
    common.check_vectors(y, same_dtype=False)
    if x.shape[0] != xlen or y.shape[0] != ylen:
        op = "Aᵀ x" if transposed else "A x"
        raise ValueError(f"{op} + y with A {tuple(a.shape)} needs x of "
                         f"length {xlen} and y of length {ylen}, got "
                         f"{x.shape[0]} and {y.shape[0]}")
    for v in (x, y):
        if v.dtype != a.dtype:
            raise ValueError(f"operand dtypes disagree: A {a.dtype}, "
                             f"vector {v.dtype}")
    return m, n


def _launch(entry, a, x, alpha, beta, y, out_len, splits, extent):
    """Run one C entry point of csrc/gemv.cu; returns (out, combined)."""
    for v in (x, y):
        if not v.is_contiguous():
            raise ValueError("the level-2 kernels take contiguous vectors")
    m, n = a.shape
    out = torch.empty(out_len, dtype=a.dtype, device=a.device)
    work = (torch.empty((splits, out_len), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    scal = common.scalar_block([alpha, beta], a.device)
    cuda.launch("gemv", entry, a, cuda.ptr(a), cuda.ptr(x), cuda.ptr(y),
                cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal), m, n, extent,
                splits)
    return out, splits > 1


@common.counted
def gemv(alpha, a, x, beta, y):
    """y' = alpha A x + beta y for A (m, n), x (n,), y (m,)."""
    m, n = _check(a, x, y, transposed=False)
    if not common.on_card(a, x, y):
        gemv.plain_calls += 1
        return gemv_plain(alpha, a, x, beta, y)
    splits, chunk = gemv_plan(m, n, a.element_size())
    out, combined = _launch("repro_gemv", a, x, alpha, beta, y, m, splits,
                            chunk)
    gemv.launches += 1
    gemv.finish_launches += combined
    return out


@common.counted
def gemvt(alpha, a, x, beta, y):
    """y' = alpha Aᵀ x + beta y for A (m, n), x (m,), y (n,); Aᵀ is
    never formed."""
    m, n = _check(a, x, y, transposed=True)
    if not common.on_card(a, x, y):
        gemvt.plain_calls += 1
        return gemvt_plain(alpha, a, x, beta, y)
    splits, rows = gemvt_plan(m, n, a.element_size())
    out, combined = _launch("repro_gemvt", a, x, alpha, beta, y, n, splits,
                            rows)
    gemvt.launches += 1
    gemvt.finish_launches += combined
    return out
