"""BLAS level-2 gemv (y' = alpha A x + beta y) and gemvt
(y' = alpha Aᵀ x + beta y) for Hopper, in CUDA C++ (`csrc/gemv.cu`).

Replaces `repro/kernels/gemv.py::gemv` (its `pallas_call` at gemv.py:60)
and `::gemvt` (:112). As there, the products accumulate in float32,
alpha and beta are float32 (gemv.py:73-74: not rounded to the vector
dtype, unlike axpy), `beta * y` is computed even when beta is 0, and the
result is rounded once to A's dtype.

Bound on an H100 SXM: HBM bytes, 4(mn + n + 2m) for a float32 gemv
(0.32 ms at 16384 x 16384). The kernel designs are described in
csrc/gemv.cu. Both run in one launch with no combine, alpha and beta by
value (a tensor operand is read on the card from a float32 block). This
module plans gemv's grid (one warp per row where the rows fill the card;
otherwise bands of rows over chunks of 512-byte column tiles, the chunks
folded in order by the last block of a band, on tickets that
`cuda.tickets` keeps per device and stream, and per capture and stream
under CUDA-graph capture); it plans gemvt's grid
(column tiles, row splits folded in a thread-block cluster); and it
picks each launch's route. The same gemvt mainloop gives the anchored
generator its product (`gemvt_product`).

Tuning knobs (`tune.TileConfig`, family `gemv`; `gemv_knobs`,
`gemvt_knobs`): for gemv, `block_m` sets a band's rows (at most
MAX_BAND_ROWS) and `block_n` the columns of a chunk (whole 512-byte
tiles); either one takes the band kernel, where the default plan may
take one warp per row. For gemvt, `block_m` sets the rows of a split,
from which the cluster follows (a power of two up to MAX_CLUSTER). The
ring depths (BAND_STAGES, and gemvt's 4 stages of 32 rows, a constant
of csrc/gemv.cu) are not swept. A plan other than the default folds in
another order, so its result agrees with the default's within
tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from numbers import Number
from typing import Optional, Tuple

import torch

from . import common, cuda, gemm

# gemv (csrc/gemv.cu): one warp per row where the rows fill the card
# from ROWS_BLOCKS_PER_SM blocks of ROWS_PER_BLOCK rows on each SM;
# otherwise bands of at most BAND_ROWS rows, a band's 512-byte column
# tiles dealt over chunks of at least BAND_MIN_TILES tiles, the chunks
# aiming at BAND_BLOCKS_PER_SM blocks per SM, each through a ring of
# BAND_STAGES stages (tools/sweep_gemv.py chose them on an H100)
ROWS_PER_BLOCK = 8
ROWS_BLOCKS_PER_SM = 8
BAND_ROWS = 32
BAND_MIN_TILES = 2
BAND_BLOCKS_PER_SM = 1
BAND_STAGES = 4
MAX_BAND_ROWS = 32          # csrc/gemv.cu kMaxBand
MIN_BAND_ROWS = 8           # the least band a tuned plan takes
GEMV_ROUTES = ("tma", "ldg", "rows")    # C route codes 0, 1, 2
# gemvt (csrc/gemv.cu): a column tile is 32 lanes x 16 bytes, a stage 32
# rows of it; its rows split in clusters of up to 8 blocks, at most
# SPLIT_BLOCKS_PER_SM blocks per SM in all, splits of at least
# MIN_ROWS_PER_SPLIT rows
TILE_BYTES = 512
STAGE_ROWS = 32
SPLIT_BLOCKS_PER_SM = 2
MAX_CLUSTER = 8
MIN_ROWS_PER_SPLIT = 64
ROUTES = ("tma", "ldg")     # C route codes 0 and 1


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    rows: int      # rows of a block: a band, or ROWS_PER_BLOCK (a warp each)
    chunks: int    # column chunks of a band, folded in order (1: no fold)
    tiles: int     # 512-byte column tiles of a row
    blocks: int    # the grid: bands x chunks
    band: bool     # the band kernel (routes tma, ldg), else route rows
    stages: int    # stages of the band kernel's ring (route tma)


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, n: int, itemsize: int, sms: int,
              band_rows: Optional[int] = None,
              chunk_cols: Optional[int] = None) -> GemvPlan:
    """The grid of a gemv launch on a card of `sms` SMs. One warp per
    row, with no fold, where the rows fill the card; otherwise the band
    kernel: bands of at most BAND_ROWS rows, as even as they go, each
    dealt over chunks of whole tiles (`gemv_block`) that aim at
    BAND_BLOCKS_PER_SM blocks per SM and hold at least BAND_MIN_TILES
    tiles.

    A tuned plan (`band_rows`, `chunk_cols`, either one set) takes the
    band kernel: bands of at most `band_rows` rows (BAND_ROWS when
    unset), and chunks of about `chunk_cols` columns (the default's
    chunks when unset). Raises ValueError where the band kernel refuses
    the plan: more bands than the fold has tickets (`max_bands`) where
    a band has more than one chunk."""
    tiles = common.cdiv(n, TILE_BYTES // itemsize)
    tuned = band_rows is not None or chunk_cols is not None
    row_blocks = common.cdiv(m, ROWS_PER_BLOCK)
    if not tuned and row_blocks >= ROWS_BLOCKS_PER_SM * sms:
        return GemvPlan(ROWS_PER_BLOCK, 1, tiles, row_blocks, False,
                        BAND_STAGES)
    most = BAND_ROWS if band_rows is None else band_rows
    if not 1 <= most <= MAX_BAND_ROWS:
        raise ValueError(f"gemv band rows {most}: 1 to {MAX_BAND_ROWS}")
    rows = common.cdiv(m, common.cdiv(m, most))
    bands = common.cdiv(m, rows)
    if chunk_cols is None:
        chunks = max(1, min(tiles // BAND_MIN_TILES,
                            BAND_BLOCKS_PER_SM * sms // bands))
    else:
        per = common.cdiv(chunk_cols * itemsize, TILE_BYTES)
        chunks = max(1, min(tiles, common.cdiv(tiles, per)))
    if chunks > 1 and bands > max_bands(sms):
        raise ValueError(f"gemv plan of {bands} bands x {chunks} chunks: "
                         f"the fold has {max_bands(sms)} tickets")
    return GemvPlan(rows, chunks, tiles, bands * chunks, True, BAND_STAGES)


def gemv_knobs(cfg):
    """The `gemv_plan` keywords of a tile config (block_m: band rows,
    block_n: columns per chunk), {} for None or the default config."""
    if cfg is None:
        return {}
    out = {}
    if cfg.block_m is not None:
        out["band_rows"] = min(cfg.block_m, MAX_BAND_ROWS)
    if cfg.block_n is not None:
        out["chunk_cols"] = cfg.block_n
    return out


def gemvt_knobs(cfg):
    """The `gemvt_plan` keywords of a tile config (block_m: rows per
    split), {} for None or a config without it."""
    if cfg is None or cfg.block_m is None:
        return {}
    return {"split_rows": cfg.block_m}


def gemv_footprint(itemsize: int, cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of gemv's kernels under `cfg`, for any
    shape: the band kernel's TMA ring (BAND_STAGES stages of a band's
    rows and x, 512 bytes each, csrc/gemv.cu `band_stage_bytes`) and
    its barriers and ticket flag; the rows kernel's none.
    `common.STATIC_SLACK` covers the compiler's alignment of the static
    part."""
    rows = gemv_knobs(cfg).get("band_rows", BAND_ROWS)
    ring = BAND_STAGES * (rows + 1) * TILE_BYTES
    return (common.Footprint("gemv_band_kernel/tma",
                             ring + 8 * 8 + 4 + common.STATIC_SLACK,
                             BAND_BLOCKS_PER_SM),
            common.Footprint("gemv_rows_kernel", common.STATIC_SLACK))


def gemvt_footprint(itemsize: int, cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of gemvt (and the gemvt anchor's product):
    its TMA ring of 4 stages of 32 rows of a 512-byte column tile, the
    warps' partials (8 x a tile's columns, float32), the cluster's fold
    row and the barriers. Its knob sets the grid, not the block."""
    tile = TILE_BYTES // itemsize
    ring = 4 * STAGE_ROWS * TILE_BYTES
    static = 4 * 8 + 4 * 8 * tile + 4 * tile
    return (common.Footprint("gemvt_kernel/tma", ring + static
                             + common.STATIC_SLACK, SPLIT_BLOCKS_PER_SM),)


def gemv_block(plan: GemvPlan, m: int, b: int):
    """Block b's work, as csrc/gemv.cu's kernels read it from its index:
    (band, chunk, first row, end row, its column tiles in walking
    order). Chunk c walks tiles c, c + C, c + 2C, ..., so that a band's
    chunks read neighbouring tiles at once; a band's chunks fold in
    chunk order."""
    band, chunk = divmod(b, plan.chunks)
    r0 = band * plan.rows
    return (band, chunk, r0, min(r0 + plan.rows, m),
            range(chunk, plan.tiles, plan.chunks))


def max_bands(sms: int) -> int:
    """The most bands a band plan has on a card of `sms` SMs (its rows
    leave the card short of ROWS_BLOCKS_PER_SM row blocks per SM)."""
    return common.cdiv(ROWS_BLOCKS_PER_SM * ROWS_PER_BLOCK * sms, BAND_ROWS)


def gemv_plan_for(a: torch.Tensor, tiles=None) -> GemvPlan:
    m, n = a.shape
    return gemv_plan(m, n, a.element_size(), common.sm_count(a.device),
                     **gemv_knobs(tiles))


def gemv_route(a: torch.Tensor, x: torch.Tensor, plan: GemvPlan) -> str:
    """The route of a gemv launch: "rows" for a plan of one warp per
    row; for the band kernel "tma" where TMA takes A and x (bases
    16-byte aligned, a row a multiple of 16 bytes), "ldg" otherwise.
    Shapes, dtypes and addresses only: it also answers for CPU
    tensors."""
    if not plan.band:
        return "rows"
    if (a.data_ptr() % 16 or x.data_ptr() % 16
            or a.shape[1] * a.element_size() % 16):
        return "ldg"
    return "tma"


@dataclasses.dataclass(frozen=True)
class GemvtPlan:
    tile: int      # columns of a column tile
    cluster: int   # blocks of a tile's cluster: its row splits
    rows: int      # rows of a split (whole stages where cluster > 1)
    blocks: int    # the grid: column tiles x cluster


@functools.lru_cache(maxsize=None)
def gemvt_plan(m: int, n: int, itemsize: int, sms: int,
               split_rows: Optional[int] = None) -> GemvtPlan:
    """The grid of a gemvt launch on a card of `sms` SMs: one cluster
    per column tile, its blocks splitting the tile's rows. The cluster
    is the largest power of two up to MAX_CLUSTER whose blocks over all
    tiles stay within SPLIT_BLOCKS_PER_SM x sms, with splits of at least
    MIN_ROWS_PER_SPLIT rows, each a whole number of stages and every one
    holding rows (halved until they do). A tuned plan (`split_rows`)
    takes the least power of two up to MAX_CLUSTER whose splits of
    about `split_rows` rows cover m, then the same rounding."""
    tile = TILE_BYTES // itemsize
    col_tiles = common.cdiv(n, tile)
    slots = SPLIT_BLOCKS_PER_SM * sms
    cluster = 1
    if split_rows is not None:
        while 2 * cluster <= MAX_CLUSTER and cluster * split_rows < m:
            cluster *= 2
    while (split_rows is None and 2 * cluster <= MAX_CLUSTER
           and 2 * cluster * col_tiles <= slots
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
    return gemm.load_route(a, a)


def gemvt_plan_for(a: torch.Tensor, tiles=None) -> GemvtPlan:
    m, n = a.shape
    return gemvt_plan(m, n, a.element_size(), common.sm_count(a.device),
                      **gemvt_knobs(tiles))


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


def _scalars(alpha, beta, device):
    """alpha and beta for a launch: (None, (alpha, beta)) for numbers,
    passed by value with nothing copied to the card; (a float32 block on
    the card, (0, 0)) where either is a tensor."""
    if isinstance(alpha, Number) and isinstance(beta, Number):
        return None, (float(alpha), float(beta))
    return common.scalar_block([alpha, beta], device), (0.0, 0.0)


def gemv_launch(alpha, a, x, beta, y, plan: GemvPlan, route: str):
    """One gemv launch on the card with the plan and route given (the
    wrapper's own, or a tuning tool's); returns y'. Not counted."""
    m, n = a.shape
    out = torch.empty(m, dtype=a.dtype, device=a.device)
    part = tick = None
    if plan.chunks > 1:
        part = torch.empty((plan.chunks, m), dtype=torch.float32,
                           device=a.device)
        tick = cuda.tickets(a.device, max_bands(common.sm_count(a.device)))
    scal, values = _scalars(alpha, beta, a.device)
    cuda.launch("gemv", "repro_gemv", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(part), cuda.ptr(tick),
                0 if tick is None else tick.numel(), cuda.ptr(scal),
                *values, m, n, plan.rows, plan.chunks, plan.stages,
                GEMV_ROUTES.index(route))
    return out


@common.counted
def gemv(alpha, a, x, beta, y, *, tiles=None):
    """y' = alpha A x + beta y for A (m, n), x (n,), y (m,). One launch,
    no combine. `tiles`: a tile config for `gemv_plan` (`gemv_knobs`)."""
    _check(a, x, y, transposed=False)
    if not common.on_card(a, x, y):
        gemv.plain_calls += 1
        return gemv_plain(alpha, a, x, beta, y)
    common.check_contiguous(x, y)
    plan = gemv_plan_for(a, tiles)
    route = gemv_route(a, x, plan)
    out = gemv_launch(alpha, a, x, beta, y, plan, route)
    gemv.launches += 1
    gemv.route_launches[route] += 1
    return out


gemv.route_launches = dict.fromkeys(GEMV_ROUTES, 0)   # launches per route


@common.counted
def gemvt(alpha, a, x, beta, y, *, tiles=None):
    """y' = alpha Aᵀ x + beta y for A (m, n), x (m,), y (n,); Aᵀ is
    never formed. One launch, no combine. `tiles`: a tile config for
    `gemvt_plan` (`gemvt_knobs`)."""
    m, n = _check(a, x, y, transposed=True)
    if not common.on_card(a, x, y):
        gemvt.plain_calls += 1
        return gemvt_plain(alpha, a, x, beta, y)
    common.check_contiguous(x, y)
    plan, route = gemvt_plan_for(a, tiles), gemvt_route(a)
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    scal, values = _scalars(alpha, beta, a.device)
    cuda.launch("gemv", "repro_gemvt", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(scal), *values, m, n,
                plan.rows, plan.cluster, ROUTES.index(route))
    gemvt.launches += 1
    gemvt.route_launches[route] += 1
    return out


gemvt.route_launches = dict.fromkeys(ROUTES, 0)   # launches per route


def gemvt_product(a, x, tiles=None):
    """The raw float32 Aᵀ x on the card (`repro_gemvt_acc`, gemvt's
    mainloop with no alpha, beta or y): returns (acc (n,), route).
    Counted by the caller (the anchored generator), not by `gemvt`."""
    m, n = common.check_matrix(a)
    if x.ndim != 1 or x.shape[0] != m or x.dtype != a.dtype:
        raise ValueError(f"Aᵀ x with A {tuple(a.shape)} {a.dtype} needs x "
                         f"of length {m} in that dtype, got "
                         f"{tuple(x.shape)} {x.dtype}")
    common.check_contiguous(x)
    plan, route = gemvt_plan_for(a, tiles), gemvt_route(a)
    acc = torch.empty(n, dtype=torch.float32, device=a.device)
    cuda.launch("gemv", "repro_gemvt_acc", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(acc), m, n, plan.rows, plan.cluster,
                ROUTES.index(route))
    return acc, route
