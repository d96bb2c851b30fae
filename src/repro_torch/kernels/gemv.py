"""BLAS level-2 gemv (y' = alpha A x + beta y) and gemvt
(y' = alpha Aᵀ x + beta y) for Hopper, in CUDA C++ (`csrc/gemv.cu`).

Replaces `repro/kernels/gemv.py::gemv` (its `pallas_call` at gemv.py:60)
and `::gemvt` (:112). As there, the products accumulate in float32,
alpha and beta are float32 (gemv.py:73-74: not rounded to the vector
dtype, unlike axpy), `beta * y` is computed even when beta is 0, and the
result is rounded once to A's dtype.

Bound on an H100 SXM: HBM bytes, 4(mn + n + 2m) for a float32 gemv
(0.32 ms at 16384 x 16384). The kernel designs are described in
csrc/gemv.cu. This module chooses gemv's split of the reduction axis
and its float32 scratch, and gemvt's grid (column tiles, row splits
folded in a thread-block cluster) and route. The same gemvt mainloop
gives the anchored generator its product (`gemvt_product`).
"""
from __future__ import annotations

import dataclasses
import functools
from numbers import Number

import torch

from . import common, cuda, gemm

# gemv: blocks that fill the card once: 132 SMs x 8 resident blocks
TARGET_BLOCKS = 132 * 8
ROWS_PER_BLOCK = 8     # gemv: one warp per row
MIN_ROWS_PER_SPLIT = 64
# gemvt (csrc/gemv.cu): a column tile is 32 lanes x 16 bytes, a stage 32
# rows of it; its rows split in clusters of up to 8 blocks, at most
# SPLIT_BLOCKS_PER_SM blocks per SM in all
TILE_BYTES = 512
STAGE_ROWS = 32
SPLIT_BLOCKS_PER_SM = 2
MAX_CLUSTER = 8
ROUTES = ("tma", "ldg")     # C route codes 0 and 1


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


@dataclasses.dataclass(frozen=True)
class GemvtPlan:
    tile: int      # columns of a column tile
    cluster: int   # blocks of a tile's cluster: its row splits
    rows: int      # rows of a split (whole stages where cluster > 1)
    blocks: int    # the grid: column tiles x cluster


@functools.lru_cache(maxsize=None)
def gemvt_plan(m: int, n: int, itemsize: int, sms: int) -> GemvtPlan:
    """The grid of a gemvt launch on a card of `sms` SMs: one cluster
    per column tile, its blocks splitting the tile's rows. The cluster
    is the largest power of two up to MAX_CLUSTER whose blocks over all
    tiles stay within SPLIT_BLOCKS_PER_SM x sms, with splits of at least
    MIN_ROWS_PER_SPLIT rows, each a whole number of stages and every one
    holding rows (halved until they do)."""
    tile = TILE_BYTES // itemsize
    col_tiles = common.cdiv(n, tile)
    slots = SPLIT_BLOCKS_PER_SM * sms
    cluster = 1
    while (2 * cluster <= MAX_CLUSTER and 2 * cluster * col_tiles <= slots
           and m // (2 * cluster) >= MIN_ROWS_PER_SPLIT):
        cluster *= 2
    rows = m
    while cluster > 1:
        rows = common.cdiv(common.cdiv(m, cluster), STAGE_ROWS) * STAGE_ROWS
        if (cluster - 1) * rows < m:
            break
        cluster //= 2
        rows = m
    return GemvtPlan(tile, cluster, rows, col_tiles * cluster)


def gemvt_block(plan: GemvtPlan, m: int, b: int):
    """Block b's work, as csrc/gemv.cu's gemvt_kernel reads it from its
    index: (column tile, rank in the tile's cluster, first row, end
    row). The cluster's partials fold in rank order."""
    tile, rank = divmod(b, plan.cluster)
    r0 = rank * plan.rows
    return tile, rank, r0, min(r0 + plan.rows, m)


def gemvt_route(a: torch.Tensor) -> str:
    """The route that loads A's stages: "tma" where TMA takes A (base
    16-byte aligned, a row a multiple of 16 bytes), "ldg" otherwise.
    Shapes, dtypes and addresses only: it also answers for CPU
    tensors."""
    return gemm.gemm_route(a, a)


def gemvt_plan_for(a: torch.Tensor) -> GemvtPlan:
    m, n = a.shape
    return gemvt_plan(m, n, a.element_size(), common.sm_count(a.device))


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


@common.counted
def gemv(alpha, a, x, beta, y):
    """y' = alpha A x + beta y for A (m, n), x (n,), y (m,)."""
    m, n = _check(a, x, y, transposed=False)
    if not common.on_card(a, x, y):
        gemv.plain_calls += 1
        return gemv_plain(alpha, a, x, beta, y)
    common.check_contiguous(x, y)
    splits, chunk = gemv_plan(m, n, a.element_size())
    out = torch.empty(m, dtype=a.dtype, device=a.device)
    work = (torch.empty((splits, m), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    scal = common.scalar_block([alpha, beta], a.device)
    cuda.launch("gemv", "repro_gemv", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal),
                m, n, chunk, splits)
    gemv.launches += 1
    gemv.finish_launches += splits > 1
    return out


@common.counted
def gemvt(alpha, a, x, beta, y):
    """y' = alpha Aᵀ x + beta y for A (m, n), x (m,), y (n,); Aᵀ is
    never formed. One launch, no combine."""
    m, n = _check(a, x, y, transposed=True)
    if not common.on_card(a, x, y):
        gemvt.plain_calls += 1
        return gemvt_plain(alpha, a, x, beta, y)
    common.check_contiguous(x, y)
    plan, route = gemvt_plan_for(a), gemvt_route(a)
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    # numbers go by value (nothing copied to the card); a tensor operand
    # is read on the card from a float32 block
    numbers = isinstance(alpha, Number) and isinstance(beta, Number)
    scal = None if numbers else common.scalar_block([alpha, beta],
                                                    a.device)
    values = (float(alpha), float(beta)) if numbers else (0.0, 0.0)
    cuda.launch("gemv", "repro_gemvt", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(scal), *values, m, n,
                plan.rows, plan.cluster, ROUTES.index(route))
    gemvt.launches += 1
    gemvt.route_launches[route] += 1
    return out


gemvt.route_launches = dict.fromkeys(ROUTES, 0)   # launches per route


def gemvt_product(a, x):
    """The raw float32 Aᵀ x on the card (`repro_gemvt_acc`, gemvt's
    mainloop with no alpha, beta or y): returns (acc (n,), route).
    Counted by the caller (the anchored generator), not by `gemvt`."""
    m, n = common.check_matrix(a)
    if x.ndim != 1 or x.shape[0] != m or x.dtype != a.dtype:
        raise ValueError(f"Aᵀ x with A {tuple(a.shape)} {a.dtype} needs x "
                         f"of length {m} in that dtype, got "
                         f"{tuple(x.shape)} {x.dtype}")
    common.check_contiguous(x)
    plan, route = gemvt_plan_for(a), gemvt_route(a)
    acc = torch.empty(n, dtype=torch.float32, device=a.device)
    cuda.launch("gemv", "repro_gemvt_acc", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(acc), m, n, plan.rows, plan.cluster,
                ROUTES.index(route))
    return acc, route
