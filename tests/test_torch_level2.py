"""Port parity for slice 2: the level-2 matvecs (gemv, gemvt, symv), the
level-2 composites, and the gemv/gemvt/symv-anchored fusion groups that
carry every Krylov solver's matvec stage. The same seeded numpy inputs
go through the reference package (its Pallas kernels in interpret mode,
its `Program`) and through repro_torch on the CPU, where every wrapper
runs its plain version and every anchored group its plain splice.

Tolerances:
* matvec rows (kernels): rtol 1e-5 with atol 1e-5 * sum_j |alpha A_ij x_j|
  + 1e-6 * |beta y_i|, the sums taken in float64 (another summation
  order in float32); bfloat16: both sides accumulate the same bfloat16
  inputs in float32 and round the row once, so that bound plus half a
  bfloat16 unit of each side, 2**-8 * (|got_i| + |want_i|);
* program outputs: reductions and matvec rows rtol 1e-5 with
  atol 1e-5 * sqrt(n) * scale, which stands in for 1e-5 * sum|terms|
  (n terms of mixed sign sum to about |result| * sqrt(n)); element-wise
  outputs of level-1 routines only, 1e-6 of their scale.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Program as JProgram, codegen as jcodegen
from repro.core.lowering import lower as jlower
from repro.kernels import gemv as jgemv, ops as jops, symv as jsymv
from repro.solvers import specs as jsolver_specs
from repro_torch.core import Program, codegen, lowering
from repro_torch.core.runtime import inputs_from_numpy, results_to_numpy
from repro_torch.kernels import (anchored, common, cuda, gemv as t_gemv,
                                 ops as tops, symv as t_symv)

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rng(seed):
    return np.random.default_rng(seed)


def _mat(rng, m, n):
    return rng.standard_normal((m, n)).astype(np.float32)


def _sym(rng, n):
    a = rng.standard_normal((n, n))
    return ((a + a.T) / 2).astype(np.float32)


def _vec(rng, n):
    return rng.standard_normal(n).astype(np.float32)


def _both(arrays, dtype):
    """The same values for both packages: jax arrays and CPU tensors."""
    jx = [jnp.asarray(a, dtype=_JNP[dtype]) for a in arrays]
    tx = inputs_from_numpy({str(i): np.asarray(a) for i, a in enumerate(jx)},
                           device="cpu")
    return jx, [tx[str(i)] for i in range(len(jx))]


def _f64(v):
    if torch.is_tensor(v):
        return v.double().numpy()
    return np.asarray(v, np.float32).astype(np.float64)


def _check_rows(got, want, a, x, alpha, beta, y, dtype):
    """|got - want| <= 1e-5 sum|alpha A x| + 1e-6 |beta y| + 1e-5 |want|
    per row, plus half a bfloat16 unit of each side in bfloat16."""
    got, want = _f64(got), _f64(want)
    tol = 1e-5 * abs(alpha) * (np.abs(a) @ np.abs(x)) \
        + 1e-6 * abs(beta) * np.abs(y) + 1e-5 * np.abs(want)
    if dtype == "bfloat16":
        tol = tol + 2.0 ** -8 * (np.abs(got) + np.abs(want))
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    assert np.all(err <= tol), float(np.max(err - tol))


# ---------------------------------------------------------------------------
# Rows 6-8: gemv, gemvt, symv
# ---------------------------------------------------------------------------

SHAPES = [(391, 133), (257, 96), (31, 1000)]
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["gemv", "gemvt"])
def test_matvec_matches_reference(name, shape, dtype):
    m, n = shape
    rng = _rng(m + n)
    xlen, ylen = (m, n) if name == "gemvt" else (n, m)
    arrays = [_mat(rng, m, n), _vec(rng, xlen), _vec(rng, ylen)]
    (ja, jx, jy), (ta, tx, ty) = _both(arrays, dtype)
    alpha, beta = 1.3, -0.7
    want = getattr(jgemv, name)(alpha, ja, jx, beta, jy)
    got = getattr(tops, name)(alpha, ta, tx, beta, ty)
    assert got.dtype == _TORCH[dtype] and got.shape == (ylen,)
    a64 = _f64(ta).T if name == "gemvt" else _f64(ta)
    _check_rows(got, want, a64, _f64(tx), alpha, beta, _f64(ty), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 261])
def test_symv_matches_reference_with_nan_upper_triangle(n, dtype):
    rng = _rng(n)
    a = _sym(rng, n)
    a_nan = a.copy()
    a_nan[np.triu_indices(n, 1)] = np.nan
    arrays = [a_nan, a, _vec(rng, n), _vec(rng, n)]
    (ja, _, jx, jy), (ta, tclean, tx, ty) = _both(arrays, dtype)
    alpha, beta = 0.9, 0.4
    want = jsymv.symv(alpha, ja, jx, beta, jy)
    got = tops.symv(alpha, ta, tx, beta, ty)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, tops.symv(alpha, tclean, tx, beta, ty))
    _check_rows(got, want, _f64(tclean), _f64(tx), alpha, beta, _f64(ty),
                dtype)


# symv's grid and scratch (csrc/symv.cu, planned by kernels/symv.py)
SYMV_PLAN_SIZES = [1, 63, 64, 65, 200, 515, 4099, 16381, 16384]


@pytest.mark.parametrize("n", SYMV_PLAN_SIZES)
def test_symv_plan_covers_every_lower_tile_once(n):
    plan = t_symv.symv_plan(n)
    nt = plan.tiles
    assert nt == -(-n // t_symv.TILE) and plan.pitch >= n
    seen, slots = [], set()
    for b in range(plan.blocks):
        j, c, i0, i1 = t_symv.chunk_of(plan, b)
        assert 0 <= j <= i0 < i1 <= nt and i1 - i0 <= plan.chunk
        assert i0 == j + c * plan.chunk and c < plan.chunks
        seen += [(i, j) for i in range(i0, i1)]
        assert (j, c) not in slots          # one column-product slot each
        slots.add((j, c))
    assert sorted(seen) == sorted((i, j) for j in range(nt)
                                  for i in range(j, nt))
    assert plan.blocks == len(slots)
    # chunks short enough that the grid holds many waves at the sizes
    # that have that many tiles
    assert plan.blocks >= min(nt * (nt + 1) // 2, t_symv.TARGET_BLOCKS)


@pytest.mark.parametrize("n", SYMV_PLAN_SIZES)
def test_symv_fold_reads_each_written_slot_in_one_order(n):
    """Row i folds the row products of tiles (I, 0..I) and the column
    products of column I's chunks, each written by exactly one block,
    in ascending slot order; no row reads a slot nobody wrote."""
    plan = t_symv.symv_plan(n)
    written = {}
    for b in range(plan.blocks):
        j, c, i0, i1 = t_symv.chunk_of(plan, b)
        for i in range(i0, i1):
            written.setdefault((j, i), []).append(b)   # slot j, rows I
        written.setdefault((plan.tiles + c, j), []).append(b)
    assert all(len(bs) == 1 for bs in written.values())
    for i in sorted({0, n // 2, n - 1, min(n - 1, 64)}):
        order = t_symv.fold_slots(plan, i)
        assert order == sorted(order) and len(set(order)) == len(order)
        assert all((slot, i // t_symv.TILE) in written for slot in order)
        # every tile of S's row I is covered: (I, J <= I) by row
        # products, (J > I, I) through the column chunks
        assert len([s for s in order if s < plan.tiles]) == \
            i // t_symv.TILE + 1


def _symv_emulated(alpha, a, x, beta, y):
    """csrc/symv.cu's arithmetic in float32 torch: every block's row and
    column products written to a (slots, pitch) scratch as the kernel
    lays it out, then the fold in its order."""
    n, tile = a.shape[0], t_symv.TILE
    plan = t_symv.symv_plan(n)
    pad = plan.pitch
    af = torch.zeros(pad, pad)
    af[:n, :n] = a.float()
    xf = torch.zeros(pad)
    xf[:n] = x.float()
    lower = torch.ones(tile, tile, dtype=torch.bool).tril()
    work = torch.full((plan.slots, pad), float("nan"))
    for b in range(plan.blocks):
        j, c, i0, i1 = t_symv.chunk_of(plan, b)
        cols = slice(j * tile, (j + 1) * tile)
        col_sum = torch.zeros(tile)
        for i in range(i0, i1):
            rows = slice(i * tile, (i + 1) * tile)
            t = af[rows, cols]
            if i == j:      # selects, never a 0/1 product (NaN above)
                row_t = torch.where(lower, t, torch.zeros(()))
                col_t = torch.where(lower.tril(-1), t, torch.zeros(()))
            else:
                row_t = col_t = t
            work[j, rows] = row_t @ xf[cols]
            col_sum += col_t.T @ xf[rows]
        work[plan.tiles + c, cols] = col_sum
    s = common.scalar_block([alpha, beta], a.device)
    out = torch.empty(n)
    for i in range(n):
        slots = t_symv.fold_slots(plan, i)
        parts = [torch.zeros((), dtype=torch.float32)
                 for _ in range(t_symv.FOLD_WARPS)]
        for q, slot in enumerate(slots):
            parts[q % t_symv.FOLD_WARPS] = parts[q % t_symv.FOLD_WARPS] \
                + work[slot, i]
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        out[i] = s[0] * acc + s[1] * y[i].float()
    return out.to(a.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 515])
def test_symv_kernel_layout_matches_reference(n, dtype):
    """The kernel's partials and fold, emulated in torch with NaN in the
    upper triangle, against the reference's Pallas symv (interpret
    mode) on the clean matrix."""
    rng = _rng(n + 7)
    a = _sym(rng, n)
    a_nan = a.copy()
    a_nan[np.triu_indices(n, 1)] = np.nan
    (ja, jx, jy), (ta, tx, ty) = _both([a, _vec(rng, n), _vec(rng, n)],
                                       dtype)
    t_nan = _both([a_nan], dtype)[1][0]
    alpha, beta = 1.3, -0.7
    want = jsymv.symv(alpha, ja, jx, beta, jy)
    got = _symv_emulated(alpha, t_nan, tx, beta, ty)
    assert got.dtype == _TORCH[dtype] and torch.isfinite(got.float()).all()
    _check_rows(got, want, _f64(ta), _f64(tx), alpha, beta, _f64(ty),
                dtype)


# gemvt's grid (csrc/gemv.cu, planned by kernels/gemv.py): square,
# ragged, short-wide, one-row and narrow shapes, on the H100's 132 SMs
GEMVT_PLAN_CASES = [(16384, 16384, 4), (16384, 16384, 2), (16381, 16379, 4),
                    (31, 2 ** 20, 4), (21, 16384, 4), (1, 16384, 4),
                    (1, 2 ** 20, 2), (520, 300, 4), (16384, 64, 4),
                    (100000, 4096, 2)]


@pytest.mark.parametrize("m,n,itemsize", GEMVT_PLAN_CASES)
def test_gemvt_plan_covers_every_row_once(m, n, itemsize):
    """Every (row, column tile) is walked by exactly one block; a tile's
    row splits are the blocks of one cluster, in rank order, so the fold
    (ranks in order) adds the rows in one fixed order; a split is a
    whole number of stages and holds rows; the grid stays within 2
    blocks per SM wherever it splits rows."""
    sms = 132
    plan = t_gemv.gemvt_plan(m, n, itemsize, sms)
    col_tiles = -(-n // plan.tile)
    assert plan.tile * itemsize == t_gemv.TILE_BYTES
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.blocks == col_tiles * plan.cluster
    assert plan.cluster == 1 or plan.rows % t_gemv.STAGE_ROWS == 0
    splits = {}                       # tile -> [(rank, r0, r1)]
    for b in range(plan.blocks):
        tile, rank, r0, r1 = t_gemv.gemvt_block(plan, m, b)
        assert b // plan.cluster == tile          # one cluster per tile
        assert 0 <= tile < col_tiles and 0 <= r0 < r1 <= m
        splits.setdefault(tile, []).append((rank, r0, r1))
    assert sorted(splits) == list(range(col_tiles))
    for parts in splits.values():
        assert [rank for rank, _, _ in parts] == list(range(plan.cluster))
        bounds = [(r0, r1) for _, r0, r1 in parts]
        assert bounds[0][0] == 0 and bounds[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if plan.cluster > 1:
        assert plan.blocks <= t_gemv.SPLIT_BLOCKS_PER_SM * sms
        assert plan.rows >= t_gemv.MIN_ROWS_PER_SPLIT
    # the same plan from the same shape: a result repeats bitwise
    assert t_gemv.gemvt_plan(m, n, itemsize, sms) == plan


def _gemvt_emulated(alpha, a, x, beta, y, sms):
    """csrc/gemv.cu's gemvt arithmetic in float32 torch on a card of
    `sms` SMs: lane accumulators over warp w's rows (r0 + w, r0 + w + 8,
    ...) in order, the 8 warps in order, the cluster's ranks in order,
    then alpha and beta."""
    m, n = a.shape
    plan = t_gemv.gemvt_plan(m, n, a.element_size(), sms)
    af, xf = a.float(), x.float()
    out = torch.empty(n)
    for b in range(plan.blocks):
        tile, rank, r0, r1 = t_gemv.gemvt_block(plan, m, b)
        cols = slice(tile * plan.tile, min((tile + 1) * plan.tile, n))
        total = torch.zeros(cols.stop - cols.start)
        for w in range(8):
            acc = torch.zeros_like(total)
            for r in range(r0 + w, r1, 8):
                acc = acc + af[r, cols] * xf[r]
            total = total + acc
        # blocks come in rank order: rank 0 starts the tile's sum
        out[cols] = total if rank == 0 else out[cols] + total
    s = common.scalar_block([alpha, beta], a.device)
    return (s[0] * out + s[1] * y.float()).to(a.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,sms", [((200, 300), 132), ((200, 300), 1),
                                       ((1000, 129), 132), ((31, 1000), 132),
                                       ((1, 513), 132), ((257, 96), 132)])
def test_gemvt_kernel_layout_matches_reference(shape, sms, dtype):
    """The kernel's split, walk and fold, emulated in torch for the
    H100's 132 SMs (row splits in clusters of 2, 4 and 8 at these
    shapes) and for one SM (none), against the reference's Pallas gemvt
    (interpret mode)."""
    m, n = shape
    rng = _rng(m * n)
    (ja, jx, jy), (ta, tx, ty) = _both([_mat(rng, m, n), _vec(rng, m),
                                        _vec(rng, n)], dtype)
    alpha, beta = 1.3, -0.7
    want = jgemv.gemvt(alpha, ja, jx, beta, jy)
    got = _gemvt_emulated(alpha, ta, tx, beta, ty, sms)
    assert got.dtype == _TORCH[dtype] and got.shape == (n,)
    _check_rows(got, want, _f64(ta).T, _f64(tx), alpha, beta, _f64(ty),
                dtype)


# gemv's grid (csrc/gemv.cu, planned by kernels/gemv.py): one warp per
# row where the rows fill the card, else bands over column chunks
GEMV_PLAN_CASES = [(16384, 16384, 4), (16384, 16384, 2), (16381, 16379, 4),
                   (31, 2 ** 20, 4), (21, 16384, 4), (1, 16384, 4),
                   (1, 2 ** 20, 2), (520, 300, 4), (16384, 64, 4),
                   (100000, 4096, 2)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("m,n,itemsize", GEMV_PLAN_CASES)
def test_gemv_plan_covers_every_column_once(m, n, itemsize, sms):
    """Every (row, column tile) is walked by exactly one block: bands
    cut the rows, a band's chunks deal its tiles, each chunk walking its
    tiles in increasing order; a band's chunks are consecutive blocks in
    chunk order, the order of the fold; a fold's chunks hold at least
    BAND_MIN_TILES tiles; the same shape gives the same plan."""
    plan = t_gemv.gemv_plan(m, n, itemsize, sms)
    tile = t_gemv.TILE_BYTES // itemsize
    assert plan.tiles == -(-n // tile)
    bands = -(-m // plan.rows)
    assert plan.blocks == bands * plan.chunks
    row_blocks = -(-m // t_gemv.ROWS_PER_BLOCK)
    fills = row_blocks >= t_gemv.ROWS_BLOCKS_PER_SM * sms
    assert plan.band == (not fills)
    if plan.band:
        assert 1 <= plan.rows <= t_gemv.BAND_ROWS
        assert bands <= t_gemv.max_bands(sms)
        assert 1 <= plan.chunks <= plan.tiles
        assert (plan.chunks == 1
                or plan.tiles // plan.chunks >= t_gemv.BAND_MIN_TILES)
        assert (plan.chunks == 1
                or plan.blocks <= t_gemv.BAND_BLOCKS_PER_SM * sms)
    else:
        assert (plan.rows, plan.chunks) == (t_gemv.ROWS_PER_BLOCK, 1)
    rows_of, walks = {}, {}
    for b in range(plan.blocks):
        band, chunk, r0, r1, walk = t_gemv.gemv_block(plan, m, b)
        assert b == band * plan.chunks + chunk       # chunks in fold order
        assert 0 <= r0 < r1 <= m
        assert rows_of.setdefault(band, (r0, r1)) == (r0, r1)
        assert list(walk) == sorted(walk) and len(walk) >= 1
        walks.setdefault(band, []).extend(walk)
    spans = [rows_of[k] for k in range(bands)]
    assert spans[0][0] == 0 and spans[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for band in range(bands):
        assert sorted(walks[band]) == list(range(plan.tiles))
    # the same plan from the same shape, cached or not: a result repeats
    # bitwise
    t_gemv.gemv_plan.cache_clear()
    assert t_gemv.gemv_plan(m, n, itemsize, sms) == plan


def _warp_sum(v):
    """csrc/common.cuh's warp_sum over the last axis (32 lanes): the
    xor butterfly, 16 then 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _gemv_emulated(alpha, a, x, beta, y, sms):
    """csrc/gemv.cu's gemv arithmetic in float32 torch on a card of `sms`
    SMs. Route rows: lane l of a row's warp walks columns l V + 32 V k +
    v (16-byte path; one column at a time, l + 32 k, where n is not a
    multiple of V), then the butterfly. The band kernel: lane l of a
    row's warp accumulates, over its chunk's tiles in walking order,
    columns tile TC + l V + v (masked past n), the butterfly gives the
    chunk's partial, and the band's partials fold in chunk order, lane l
    adding chunks l, l + 32, ..., then a butterfly; then alpha and
    beta."""
    m, n = a.shape
    plan = t_gemv.gemv_plan(m, n, a.element_size(), sms)
    v_width = 16 // a.element_size()
    af, xf = a.float(), x.float()
    lanes = torch.arange(32)
    if not plan.band:
        acc = torch.zeros(m, 32)
        if n % v_width == 0:
            for c0 in range(0, n, 32 * v_width):
                for v in range(v_width):
                    cols = c0 + lanes * v_width + v
                    live = cols < n
                    cols = torch.where(live, cols, 0)
                    acc = acc + torch.where(live, af[:, cols] * xf[cols], 0.0)
        else:
            for c0 in range(0, n, 32):
                cols = c0 + lanes
                live = cols < n
                cols = torch.where(live, cols, 0)
                acc = acc + torch.where(live, af[:, cols] * xf[cols], 0.0)
        total = _warp_sum(acc)
    else:
        tc = 32 * v_width
        width = plan.tiles * tc
        apad = torch.zeros(m, width)
        apad[:, :n] = af
        xpad = torch.zeros(width)
        xpad[:n] = xf
        part = torch.zeros(plan.chunks, m)
        for b in range(plan.blocks):
            _, chunk, r0, r1, walk = t_gemv.gemv_block(plan, m, b)
            acc = torch.zeros(r1 - r0, 32)
            for tile in walk:
                for v in range(v_width):
                    cols = tile * tc + lanes * v_width + v
                    acc = acc + apad[r0:r1][:, cols] * xpad[cols]
            part[chunk, r0:r1] = _warp_sum(acc)
        if plan.chunks == 1:
            total = part[0]
        else:
            fold = torch.zeros(m, 32)
            for c in range(plan.chunks):      # lane c % 32, in order
                fold[:, c % 32] = fold[:, c % 32] + part[c]
            total = _warp_sum(fold)
    s = common.scalar_block([alpha, beta], a.device)
    return (s[0] * total + s[1] * y.float()).to(a.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,sms", [((31, 4096), 132), ((21, 2000), 132),
                                       ((100, 4096), 132), ((200, 300), 132),
                                       ((1, 1000), 132), ((31, 4096), 1),
                                       ((257, 96), 1), ((70, 333), 1)])
def test_gemv_kernel_layout_matches_reference(shape, sms, dtype):
    """The kernel's split, walk and fold, emulated in torch for the
    H100's 132 SMs (bands folded over 2-8 interleaved chunks, a ragged
    last tile, several bands, bands with no fold) and for one SM (a band
    with no fold; one warp per row on the 16-byte and the one-column
    paths), against the reference's Pallas gemv (interpret mode)."""
    m, n = shape
    rng = _rng(m * n + 1)
    (ja, jx, jy), (ta, tx, ty) = _both([_mat(rng, m, n), _vec(rng, n),
                                        _vec(rng, m)], dtype)
    alpha, beta = 1.3, -0.7
    want = jgemv.gemv(alpha, ja, jx, beta, jy)
    got = _gemv_emulated(alpha, ta, tx, beta, ty, sms)
    assert got.dtype == _TORCH[dtype] and got.shape == (m,)
    _check_rows(got, want, _f64(ta), _f64(tx), alpha, beta, _f64(ty),
                dtype)


COMPOSITES = {
    "gesummv": (lambda m, a, b, x, r: m.gesummv(0.4, a, 0.6, b, x)),
    "atax": (lambda m, a, b, x, r: m.atax(a, x)),
    "bicgk": (lambda m, a, b, x, r: m.bicgk(a, x, r)),
}


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_level2_composites_match_reference(name):
    m, n = 257, 96
    rng = _rng(3)
    arrays = [_mat(rng, m, n), _mat(rng, m, n), _vec(rng, n), _vec(rng, m)]
    jargs, targs = _both(arrays, "float32")
    want = COMPOSITES[name](jops, *jargs)
    got = COMPOSITES[name](tops, *targs)
    if name != "bicgk":
        want, got = (want,), (got,)
    a = arrays[0].astype(np.float64)
    for g, w in zip(got, want):
        scale = np.abs(a).sum() / min(m, n) * np.abs(arrays[2]).max()
        if name == "atax":   # Aᵀ (A x): the second product's terms
            scale *= np.abs(a).sum(axis=0).max()
        np.testing.assert_allclose(_f64(g), _f64(w), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_cpu_tensors_run_the_plain_versions():
    rng = _rng(5)
    a, x, y = (torch.from_numpy(v) for v in (_sym(rng, 40), _vec(rng, 40),
                                             _vec(rng, 40)))
    wrappers = list(tops.KERNELS.values())
    common.reset_counts(*wrappers)
    tops.gemv(1.0, a, x, 0.0, y)
    tops.gemvt(1.0, a, x, 0.0, y)
    tops.symv(1.0, a, x, 0.0, y)
    tops.atax(a, x)
    assert (tops.gemv.plain_calls, tops.gemvt.plain_calls,
            tops.symv.plain_calls) == (2, 2, 1)
    assert all(w.launches == w.finish_launches == 0 for w in wrappers)


@pytest.mark.parametrize("bad", [
    lambda: tops.gemv(1.0, torch.zeros(4, 3), torch.zeros(4),
                      0.0, torch.zeros(4)),                 # x length
    lambda: tops.gemvt(1.0, torch.zeros(4, 3), torch.zeros(3),
                       0.0, torch.zeros(3)),                # x length
    lambda: tops.gemv(1.0, torch.zeros(3, 4).T, torch.zeros(3),
                      0.0, torch.zeros(4)),                 # not contiguous
    lambda: tops.gemv(1.0, torch.zeros(4), torch.zeros(4),
                      0.0, torch.zeros(1)),                 # not 2-D
    lambda: tops.gemv(1.0, torch.zeros(2, 3), torch.zeros(3),
                      0.0, torch.zeros(2, dtype=torch.bfloat16)),
    lambda: tops.symv(1.0, torch.zeros(3, 4), torch.zeros(4),
                      0.0, torch.zeros(4)),                 # not square
])
def test_level2_wrappers_reject_bad_operands(bad):
    with pytest.raises(ValueError):
        bad()


# ---------------------------------------------------------------------------
# The CUDA build: no fallback
# ---------------------------------------------------------------------------


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build(["gemv"])


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'gemv.cu(1): error: no such thing'\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda, "nvcc", lambda: str(fake))
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no such thing"):
        cuda.build(["gemv", "symv"])
    assert not list((tmp_path / "build" / "cuda").glob("*.so"))


def test_library_path_follows_the_sources(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path))
    paths = {stem: cuda.library_path(stem) for stem in cuda.ENTRIES}
    assert set(cuda.ENTRIES) == {p.stem for p in cuda.CSRC.glob("*.cu")}
    assert len({p.name for p in paths.values()}) == len(paths)
    for p in paths.values():
        assert p.parent == tmp_path / "cuda" and p.suffix == ".so"


def test_launch_errors_raise():
    cuda.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        cuda.check(9, "repro_gemv")


# ---------------------------------------------------------------------------
# Programs: every spec of tests/test_fusion_l2.py and the solver matvec
# bodies, in all three modes
# ---------------------------------------------------------------------------

# copies of tests/test_fusion_l2.py's specs, module-level and inline
FUSION_L2_SPECS = {
    "symv_dot": {"routines": [
        {"blas": "symv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": "d.x"}},
        {"blas": "dot", "name": "d", "inputs": {"y": "x"},
         "outputs": {"out": "q"}}]},
    "gemv_axpy_nrm2": {"routines": [
        {"blas": "gemv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "p", "y": "y0"},
         "connections": {"out": "up.x"}, "outputs": {"out": "q"}},
        {"blas": "axpy", "name": "up",
         "scalars": {"alpha": {"input": "neg_alpha"}}, "inputs": {"y": "r"},
         "connections": {"out": "rn.x"}, "outputs": {"out": "r_next"}},
        {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}}]},
    "upstream_producer": {"routines": [
        {"blas": "scal", "name": "sc", "scalars": {"alpha": 2.0},
         "inputs": {"x": "w"}, "connections": {"out": "mv.y"}},
        {"blas": "symv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.5},
         "inputs": {"A": "A", "x": "x"}, "outputs": {"out": "y2"}}]},
    "index_reduction": {"routines": [
        {"blas": "gemv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "y0"},
         "connections": {"out": "am.x"}},
        {"blas": "iamax", "name": "am", "outputs": {"out": "idx"}}]},
    "convexity": {"routines": [
        {"blas": "gemv", "name": "mv1",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": ["mv2.x", "up.x"]}},
        {"blas": "gemv", "name": "mv2",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "B", "y": "x"}, "connections": {"out": "up.y"}},
        {"blas": "axpy", "name": "up", "scalars": {"alpha": 2.0},
         "outputs": {"out": "z"}}]},
    "level1_convexity": {"routines": [
        {"blas": "scal", "name": "e1", "scalars": {"alpha": 3.0},
         "inputs": {"x": "x"}, "connections": {"out": ["mv.x", "e2.x"]}},
        {"blas": "gemv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "y": "x"}, "connections": {"out": "e2.y"}},
        {"blas": "axpy", "name": "e2", "scalars": {"alpha": 1.0},
         "outputs": {"out": "z"}}]},
    "ordering": {"routines": [
        {"blas": "gemv", "name": "mv1",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": "d.x"}},
        {"blas": "gemv", "name": "mv2",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "B", "x": "x", "y": "x"},
         "connections": {"out": "d.y"}},
        {"blas": "dot", "name": "d", "outputs": {"out": "s"}}]},
    "fanout": {"routines": [
        {"blas": "gemv", "name": "mv1",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": ["d.x", "mv2.x"]}},
        {"blas": "scal", "name": "e", "scalars": {"alpha": 2.0},
         "inputs": {"x": "w"}, "connections": {"out": ["mv2.y", "d.y"]}},
        {"blas": "gemv", "name": "mv2",
         "scalars": {"alpha": 1.0, "beta": 0.5},
         "inputs": {"A": "B"}, "outputs": {"out": "v"}},
        {"blas": "dot", "name": "d", "outputs": {"out": "s"}}]},
}


def _fusion_l2_inputs(name, rng):
    """The shapes tests/test_fusion_l2.py runs each spec at."""
    if name == "symv_dot":
        return dict(A=_sym(rng, 261), x=_vec(rng, 261))
    if name == "gemv_axpy_nrm2":
        m, n = 391, 133
        return dict(A=_mat(rng, m, n), p=_vec(rng, n), r=_vec(rng, m),
                    y0=np.zeros(m, np.float32), neg_alpha=-0.7)
    if name == "upstream_producer":
        return dict(A=_sym(rng, 300), x=_vec(rng, 300), w=_vec(rng, 300))
    if name == "index_reduction":
        return dict(A=_mat(rng, 700, 80), x=_vec(rng, 80),
                    y0=np.zeros(700, np.float32))
    n = {"convexity": 192, "level1_convexity": 128, "ordering": 160,
         "fanout": 140}[name]
    out = dict(A=_sym(rng, n), x=_vec(rng, n))
    if name != "level1_convexity":
        out["B"] = _sym(rng, n)
    if name == "fanout":
        out["w"] = _vec(rng, n)
    return out


def _solver_inputs(name, rng):
    n, basis = 200, 7
    a = _sym(rng, n)
    vec = {k: _vec(rng, n) for k in ("x", "b", "p", "s", "v", "w", "rhat")}
    if name == "GMRES_PROJ":
        return dict(V=_mat(rng, basis, n), w=vec["w"],
                    g=np.zeros(basis, np.float32))
    if name == "GMRES_ORTH":
        return dict(V=_mat(rng, basis, n), h=_vec(rng, basis), w=vec["w"])
    names = {"RESIDUAL": ("x", "b"), "CG_MATVEC": ("p",),
             "BICG_MATVEC1": ("p", "rhat"), "BICG_MATVEC2": ("s",),
             "POWER_STEP": ("v",), "GMRES_MATVEC": ("v",)}[name]
    return dict(A=a, **{k: vec[k] for k in names})


SOLVER_BODIES = ["RESIDUAL", "CG_MATVEC", "BICG_MATVEC1", "BICG_MATVEC2",
                 "POWER_STEP", "GMRES_MATVEC", "GMRES_PROJ", "GMRES_ORTH"]


def _run_both(raw, mode, inputs):
    want = JProgram.from_spec(raw, mode=mode)(**inputs)
    got = Program.from_spec(raw, mode=mode, device="cpu")(
        **inputs_from_numpy(inputs, device="cpu"))
    return results_to_numpy(got), {k: np.asarray(v) for k, v in
                                   want.items()}


def _assert_outputs(got, want, n, eltwise=()):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert int(g) == int(w), key
            continue
        w64 = np.asarray(w, np.float64)
        scale = float(np.abs(w64).max())
        atol = (1e-6 if key in eltwise else 1e-5 * np.sqrt(n)) * scale
        np.testing.assert_allclose(np.asarray(g, np.float64), w64,
                                   rtol=1e-5, atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(FUSION_L2_SPECS))
def test_fusion_l2_spec_matches_reference(name, mode):
    inputs = _fusion_l2_inputs(name, _rng(len(name)))
    got, want = _run_both(FUSION_L2_SPECS[name], mode, inputs)
    n = max(v.shape[-1] for v in inputs.values() if np.ndim(v) == 2)
    _assert_outputs(got, want, n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SOLVER_BODIES)
def test_solver_matvec_body_matches_reference(name, mode):
    inputs = _solver_inputs(name, _rng(len(name) + 7))
    got, want = _run_both(getattr(jsolver_specs, name), mode, inputs)
    _assert_outputs(got, want, 200)


# gemv -> vdiv -> asum: the reference's anchored kernel pads A's rows
# to whole 256-row blocks with zeros and sums the padded lanes, where
# vdiv makes them 0/0 = NaN, so its dataflow `total` is NaN whenever m
# is not a multiple of 256 (ROADMAP Queue 3). The port masks the edge;
# its dataflow result is held to the reference's unfused one.
GEMV_VDIV_SPEC = {"name": "gemv_vdiv_asum", "routines": [
    {"blas": "gemv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.0},
     "inputs": {"A": "A", "x": "x", "y": "y0"},
     "connections": {"out": "dv.x"}},
    {"blas": "vdiv", "name": "dv", "inputs": {"y": "d"},
     "connections": {"out": "as.x"}, "outputs": {"out": "q"}},
    {"blas": "asum", "name": "as", "outputs": {"out": "total"}}]}


@pytest.mark.parametrize("shape", [(391, 133), (256, 96)])
@pytest.mark.parametrize("mode", MODES)
def test_anchored_group_masks_the_ragged_edge(mode, shape):
    m, n = shape
    rng = _rng(m)
    inputs = dict(A=_mat(rng, m, n), x=_vec(rng, n),
                  y0=np.zeros(m, np.float32),
                  d=rng.uniform(1, 2, m).astype(np.float32))
    want = JProgram.from_spec(
        GEMV_VDIV_SPEC, mode="nodataflow" if mode == "dataflow" else mode)(
        **inputs)
    got = results_to_numpy(Program.from_spec(
        GEMV_VDIV_SPEC, mode=mode, device="cpu")(
        **inputs_from_numpy(inputs, device="cpu")))
    _assert_outputs(got, {k: np.asarray(v) for k, v in want.items()}, n)


def test_anchored_index_reduction_ties_keep_the_first_row():
    # |q| reaches its max at rows 5 and 650 (equal values), in different
    # output blocks of both packages' anchored kernels
    a = np.zeros((700, 4), np.float32)
    a[5, 0], a[650, 0], a[300, 1] = 3.0, -3.0, 2.0
    inputs = dict(A=a, x=np.ones(4, np.float32), y0=np.zeros(700, np.float32))
    for mode in MODES:
        got, want = _run_both(FUSION_L2_SPECS["index_reduction"], mode,
                              inputs)
        assert int(got["idx"]) == int(want["idx"]) == 5


@pytest.mark.parametrize("mode,expected", [
    ("dataflow", {"anchored_kernel": 1}),
    ("nodataflow", {"gemv": 1, "dot": 1}), ("reference", {})])
def test_cg_matvec_dispatch_structure(mode, expected):
    inputs = inputs_from_numpy(_solver_inputs("CG_MATVEC", _rng(1)),
                               device="cpu")
    prog = Program.from_spec(jsolver_specs.CG_MATVEC, mode=mode,
                             device="cpu")
    wrappers = [codegen.anchored_kernel, codegen.group_kernel,
                *tops.KERNELS.values()]
    common.reset_counts(*wrappers)
    prog(**inputs)
    calls = {w.__name__: w.plain_calls for w in wrappers if w.plain_calls}
    assert calls == expected
    assert all(w.launches == 0 for w in wrappers)


# ---------------------------------------------------------------------------
# Plans and generated sources
# ---------------------------------------------------------------------------


def _anchored_groups():
    """(label, raw spec) of every spec with a level-2 anchored group."""
    specs = [(f"fusion_l2.{k}", v) for k, v in FUSION_L2_SPECS.items()]
    for name in sorted(vars(jsolver_specs)):
        raw = getattr(jsolver_specs, name)
        if name.isupper() and isinstance(raw, dict) and "routines" in raw:
            specs.append((name, raw))
    out = []
    for label, raw in specs:
        ir = lowering.lower(raw, upto="fuse")
        for gi, g in enumerate(ir.groups):
            if g.anchor is not None and "gemm" not in \
                    ir.graph.nodes[g.anchor].blas:
                out.append((f"{label}:g{gi}", raw, gi))
    return out


ANCHORED = _anchored_groups()

_SIG_FIELDS = ("anchor", "scalar_keys", "vec_in_keys", "win_in_keys",
               "elt_out_keys", "red_out_keys", "mat_key", "cols_key",
               "rows_key", "pre", "post")


@pytest.mark.parametrize("label,raw,gi", ANCHORED,
                         ids=[a[0] for a in ANCHORED])
def test_anchored_plan_matches_reference(label, raw, gi):
    want_ir = jlower(raw, upto="fuse")
    got_ir = lowering.lower(raw, upto="fuse")
    g, jg = got_ir.groups[gi], want_ir.groups[gi]
    assert (list(g.nodes), g.anchor) == (list(jg.nodes), jg.anchor)
    got = codegen._anchored_signature(got_ir.graph, g)
    want = jcodegen._anchored_signature(want_ir.graph, jg)
    for field in _SIG_FIELDS:
        assert tuple(getattr(got, field)) == tuple(getattr(want, field)), \
            field


def test_anchored_groups_cover_every_anchor_kind():
    kinds = set()
    for label, raw, gi in ANCHORED:
        ir = lowering.lower(raw, upto="fuse")
        kinds.add(ir.graph.nodes[ir.groups[gi].anchor].blas)
    assert kinds == {"gemv", "gemvt", "symv"}
    assert len(ANCHORED) >= 12


@pytest.mark.parametrize("label,raw,gi", ANCHORED,
                         ids=[a[0] for a in ANCHORED])
def test_anchored_sources_compile_as_python(label, raw, gi):
    ir = lowering.lower(raw, upto="fuse")
    group = ir.groups[gi]
    sig = codegen._anchored_signature(ir.graph, group)
    body = codegen.anchored_body(ir.graph, group, sig)
    src = anchored.source(body)
    compile(src, f"<{label}>", "exec")
    assert "tl.dot" not in src
    assert len(body.stores) == len(sig.elt_out_keys)
    assert len(body.sums) + len(body.argmaxes) == len(sig.red_out_keys)
    # the gemv anchor's combine is a launch of its own; a product
    # anchor's epilogue is a window pass, whose last program combines
    own = sig.red_out_keys and body.anchor not in anchored.PRODUCTS
    assert src.count("@triton.jit") == (2 if own else 1)


def _offset(t):
    """The same values `offset` one element into a larger buffer: an
    odd base address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    return buf.view(t.shape).copy_(t)


# (anchor, label, matrix, route the standalone wrapper picks)
ROUTE_CASES = [
    ("symv", "aligned 64^2 f32", torch.zeros(64, 64), "tma"),
    ("symv", "aligned 64^2 bf16", torch.zeros(64, 64, dtype=torch.bfloat16),
     "tma"),
    # rows of 16381 float32 (65524 bytes) are no 16-byte multiple; the
    # route reads only shape, dtype and address, so a broadcast view
    # stands in for the 1 GB matrix
    ("symv", "16381^2 f32", torch.zeros(1, 16381).expand(16381, 16381),
     "ldg"),
    ("symv", "offset view 64^2", _offset(torch.zeros(64, 64)), "ldg"),
    ("gemvt", "aligned 31x1024 f32", torch.zeros(31, 1024), "tma"),
    ("gemvt", "16381 columns f32", torch.zeros(3, 16381), "ldg"),
    ("gemvt", "16376 columns bf16",
     torch.zeros(3, 16376, dtype=torch.bfloat16), "tma"),
    ("gemvt", "offset view 31x1024", _offset(torch.zeros(31, 1024)), "ldg"),
    ("gemv", "aligned 64^2 f32", torch.zeros(64, 64), None),
]


@pytest.mark.parametrize("anchor,label,a,route", ROUTE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ROUTE_CASES])
def test_anchored_product_route_matches_the_wrappers(anchor, label, a,
                                                     route):
    """The anchored generator counts its product under the route the
    standalone kernel's wrapper picks for the same matrix."""
    got = anchored.product_route(anchor, a)
    if route is None:
        assert got is None and anchor not in anchored.PRODUCTS
        return
    pick = t_symv.symv_route if anchor == "symv" else t_gemv.gemvt_route
    assert got == f"{anchor}/{pick(a)}" == f"{anchor}/{route}"
    assert got in anchored.ROUTES
    assert codegen.anchored_kernel.route_launches.keys() == \
        set(anchored.ROUTES)


def _anchored_case(raw, gi):
    ir = lowering.lower(raw, upto="fuse")
    group = ir.groups[gi]
    sig = codegen._anchored_signature(ir.graph, group)
    return ir, group, sig, codegen.anchored_body(ir.graph, group, sig)


@pytest.mark.parametrize("label,raw,gi", ANCHORED,
                         ids=[a[0] for a in ANCHORED])
def test_anchored_epilogue_has_no_matrix_walk(label, raw, gi):
    """A symv or gemvt anchor's Triton source is the epilogue alone (a
    window pass over the output-aligned vectors and the raw product);
    only the gemv anchor walks A in Triton."""
    _, _, sig, body = _anchored_case(raw, gi)
    src = anchored.source(body)
    walks = ("a_ptr", "lda", "xc")
    if body.anchor == "gemv":
        assert "def anchored_kernel(" in src
        assert all(w in src for w in walks)
        return
    assert body.anchor in anchored.PRODUCTS
    assert "def window_kernel(" in src and "anchored_kernel" not in src
    assert not any(w in src for w in walks)
    epi = anchored.epilogue_body(body)
    assert epi.n_inputs == body.n_inputs + 1
    acc = f"x{body.n_inputs}"
    assert f"yo = {body.alpha} * {acc} + {body.beta} * {body.rows}" in src
    assert src.count(f"{acc}_ptr") == 2     # a parameter and one load


class _TL:
    """The `tl` functions of the level-1 templates and the window pass's
    reductions, on torch tensors."""
    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    where = staticmethod(torch.where)


def _epilogue_emulated(body, scalars, vecs, acc):
    """Run the epilogue body's statements on whole float32 vectors:
    element-wise outputs, additive reductions and index reductions."""
    epi = anchored.epilogue_body(body)
    env = {"tl": _TL}
    env.update({f"s{i}": torch.tensor(v, dtype=torch.float32)
                for i, v in enumerate(scalars)})
    env.update({f"x{i}": v.float() for i, v in enumerate([*vecs, acc])})
    for line in epi.lines:
        exec(line, env)
    outs = [eval(expr, env) for expr in epi.stores]
    sums = []
    for term, post in epi.sums:
        total = eval(term, env).sum()
        sums.append(eval(post, env)(total) if post else total)
    idxs = [int(torch.argmax(eval(v, env).abs())) for v in epi.argmaxes]
    return outs, sums, idxs


# two more product-anchored shapes: an index reduction on a symv
# anchor, a producer and an element-wise consumer around a gemvt one
PRODUCT_SPECS = {
    "symv_iamax": {"routines": [
        {"blas": "symv", "name": "mv", "scalars": {"alpha": 1.0, "beta": 0.5},
         "inputs": {"A": "A", "x": "x", "y": "y"},
         "connections": {"out": "am.x"}},
        {"blas": "iamax", "name": "am", "outputs": {"out": "idx"}}]},
    "scal_gemvt_axpy_asum": {"routines": [
        {"blas": "scal", "name": "sc", "scalars": {"alpha": 2.0},
         "inputs": {"x": "w"}, "connections": {"out": "mv.y"}},
        {"blas": "gemvt", "name": "mv",
         "scalars": {"alpha": -1.0, "beta": 1.0},
         "inputs": {"A": "V", "x": "h"}, "connections": {"out": "up.x"}},
        {"blas": "axpy", "name": "up", "scalars": {"alpha": 0.5},
         "inputs": {"y": "r"}, "connections": {"out": "as.x"},
         "outputs": {"out": "z"}},
        {"blas": "asum", "name": "as", "outputs": {"out": "total"}}]},
}

# the groups whose anchor's product runs on a CUDA mainloop
ANCHORED_PRODUCTS = [c for c in ANCHORED + [
    (f"extra.{k}:g0", v, 0) for k, v in PRODUCT_SPECS.items()]
    if _anchored_case(c[1], c[2])[3].anchor in anchored.PRODUCTS]


@pytest.mark.parametrize("label,raw,gi", ANCHORED_PRODUCTS,
                         ids=[a[0] for a in ANCHORED_PRODUCTS])
def test_anchored_epilogue_computes_the_plain_splice(label, raw, gi):
    """The symv and gemvt anchors' epilogue text, run on the raw product
    with a torch stand-in for `tl`, gives the plain splice's results."""
    ir, group, sig, body = _anchored_case(raw, gi)
    rng = _rng(len(label))
    m, n = (60, 60) if body.anchor == "symv" else (13, 70)
    out_len, red_len = (n, m) if body.anchor == "gemvt" else (m, n)
    vec_ins = {}
    for key in sig.vec_in_keys:
        if key == sig.mat_key:
            a = _sym(rng, m) if body.anchor == "symv" else _mat(rng, m, n)
            vec_ins[key] = torch.from_numpy(a)
        else:
            length = red_len if key == sig.cols_key else out_len
            vec_ins[key] = torch.from_numpy(_vec(rng, length))
    scalars = {k: float(rng.uniform(0.5, 1.5)) for k in sig.scalar_keys}
    run = codegen.make_anchored_callable(ir.graph, group, torch.float32)
    want = run.plain(scalars, vec_ins)
    a, xc = vec_ins[sig.mat_key], vec_ins[sig.cols_key]
    acc = (t_symv.symv_acc if body.anchor == "symv"
           else t_gemv.gemvt_acc)(a, xc)
    row_keys = [k for k in sig.win_in_keys if k != sig.cols_key]
    outs, sums, idxs = _epilogue_emulated(
        body, [scalars[k] for k in sig.scalar_keys],
        [vec_ins[k] for k in row_keys], acc)
    got = codegen._kernel_results(
        ir.graph, sig, outs, torch.stack(sums) if sums else None,
        torch.tensor(idxs, dtype=torch.int32) if idxs else None)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w.dtype in (torch.int32, torch.int64):
            assert int(g) == int(w), key
            continue
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=key)


def test_tiled_groups_still_refused():
    """Tiled groups were refused until the gemm-anchored generator was
    ported (tests/test_torch_level3.py covers it in full): the group now
    lowers to one tiled callable and gives the reference's result on
    the CPU."""
    spec = {"routines": [
        {"blas": "gemm", "name": "mm", "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "B": "P", "C": "P"},
         "connections": {"out": "cd.x"}},
        {"blas": "coldot", "name": "cd", "inputs": {"y": "P"},
         "outputs": {"out": "d"}}]}
    prog = Program.from_spec(spec, mode="dataflow", device="cpu")
    assert [(g.nodes, g.anchor) for g in prog.groups] == [(["mm", "cd"],
                                                           "mm")]
    rng = _rng(17)
    inputs = {"A": _mat(rng, 70, 70), "P": _mat(rng, 70, 5)}
    got = prog(**inputs_from_numpy(inputs, device="cpu"))["d"]
    want = JProgram.from_spec(spec, mode="dataflow")(**inputs)["d"]
    p64 = np.abs(inputs["P"].astype(np.float64))
    terms = (p64 * (np.abs(inputs["A"]) @ p64)).sum(axis=0)  # sum|terms|
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-5,
                               atol=1e-5 * terms.max())


# ---------------------------------------------------------------------------
# chip_smoke.py keeps its own copies of the solver bodies it drives
# ---------------------------------------------------------------------------


def test_chip_smoke_solver_specs_equal_the_reference():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.SOLVER_SPECS) == {"RESIDUAL", "CG_MATVEC",
                                     "BICG_MATVEC2", "POWER_STEP",
                                     "GMRES_ORTH"}
    for name, raw in mod.SOLVER_SPECS.items():
        assert raw == getattr(jsolver_specs, name), name
    assert mod.SYMV_DOT == FUSION_L2_SPECS["symv_dot"] | {
        "name": "symv_dot"}


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["gemv", "gemvt", "symv"])
def test_level2_kernel_matches_plain_on_card(cuda_device, name, dtype):
    m, n = (515, 515) if name == "symv" else (515, 1029)
    rng = _rng(11)
    xlen, ylen = (m, n) if name == "gemvt" else (n, m)
    a = torch.from_numpy(_mat(rng, m, n))
    x, y = torch.from_numpy(_vec(rng, xlen)), torch.from_numpy(
        _vec(rng, ylen))
    a, x, y = (t.to(cuda_device, _TORCH[dtype]) for t in (a, x, y))
    wrapper = tops.KERNELS[name]
    before = wrapper.launches
    got = wrapper(1.3, a, x, -0.7, y)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    plain = getattr(t_symv if name == "symv" else t_gemv, f"{name}_plain")
    want = plain(1.3, a, x, -0.7, y)
    a64 = t_symv.symmetric_from_lower(a.cpu()) if name == "symv" \
        else a.cpu().float()
    a64 = a64.T if name == "gemvt" else a64
    _check_rows(got.cpu(), want.cpu(), _f64(a64), _f64(x.cpu()), 1.3, -0.7,
                _f64(y.cpu()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CG_MATVEC", "GMRES_ORTH", "RESIDUAL"])
def test_anchored_group_matches_plain_on_card(cuda_device, name):
    raw = _solver_inputs(name, _rng(2))
    if name == "RESIDUAL":   # not symmetric, both axes ragged
        rng = _rng(3)
        raw = dict(A=_mat(rng, 203, 197), x=_vec(rng, 197),
                   b=_vec(rng, 203))
    inputs = inputs_from_numpy(raw, device=cuda_device)
    prog = Program.from_spec(getattr(jsolver_specs, name), device="cuda")
    ref = Program.from_spec(getattr(jsolver_specs, name), mode="reference",
                            device="cuda")
    before = codegen.anchored_kernel.launches
    got = results_to_numpy(prog(**inputs))
    assert codegen.anchored_kernel.launches == before + 1
    _assert_outputs(got, results_to_numpy(ref(**inputs)), 200)
