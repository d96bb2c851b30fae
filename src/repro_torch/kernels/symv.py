"""BLAS level-2 symv (y' = alpha S x + beta y with S symmetric, stored
in A's lower triangle) for Hopper, in CUDA C++ (`csrc/symv.cu`).

Replaces `repro/kernels/symv.py::symv` (its `pallas_call` at symv.py:63).
As there, only the lower triangle is referenced (the upper one may hold
NaN), the product accumulates in float32 with float32 alpha and beta
(symv.py:77-78), and the result is rounded once to A's dtype.

Bound on an H100 SXM: the HBM bytes of the lower triangle and the
vectors, 4 n(n+1)/2 + 12 n for float32 (0.1603 ms at n = 16384). The
kernel reads each lower-triangle tile once for both of its products
(csrc/symv.cu says how); this module plans its grid and scratch and
picks its route. The same mainloop gives the anchored generator its
product (`product`).

Tuning knob (`tune.TileConfig`, family `symv`; `symv_knobs`): `block_m`
sets a chunk's length, in rows of whole tiles (block_m / TILE tiles, at
least one); TILE = 64 and the ring's 3 stages are constants of
csrc/symv.cu and are not swept. Another chunk length changes the
scratch slots and so the fold's order: the result agrees with the
default plan's within tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import common, cuda, gemm

TILE = 64                   # rows and columns of a tile of csrc/symv.cu
FOLD_WARPS = 8              # interleaved partials of a row in the fold
TARGET_BLOCKS = 4096        # blocks the chunk length aims at
ROUTES = ("tma", "ldg")     # C route codes 0 and 1
STAGES = 3                  # csrc/symv.cu kStages


@dataclasses.dataclass(frozen=True)
class SymvPlan:
    tiles: int     # nt: tile rows (and tile columns) of the triangle
    chunk: int     # tiles of a block's chunk of one tile column
    chunks: int    # chunks of the longest column: column-product slots
    blocks: int    # chunks in all: the grid

    @property
    def slots(self) -> int:
        """Scratch rows: nt row-product slots, then the column ones."""
        return self.tiles + self.chunks

    @property
    def pitch(self) -> int:
        """Scratch columns: n rounded up to whole tiles."""
        return self.tiles * TILE


@functools.lru_cache(maxsize=None)
def symv_plan(n: int, chunk_rows: Optional[int] = None) -> SymvPlan:
    """The grid and scratch of symv at order n, from n alone: chunks of
    nt(nt+1)/2 / TARGET_BLOCKS tiles (at least one), so that the grid
    holds many waves of blocks and the last ones are short. A tuned
    plan (`chunk_rows`) takes chunks of chunk_rows / TILE tiles (at
    least one, at most nt)."""
    nt = common.cdiv(n, TILE)
    if chunk_rows is None:
        chunk = max(1, nt * (nt + 1) // 2 // TARGET_BLOCKS)
    else:
        chunk = min(nt, max(1, chunk_rows // TILE))
    chunks = common.cdiv(nt, chunk)
    blocks = sum(nt - c * chunk for c in range(chunks))
    return SymvPlan(nt, chunk, chunks, blocks)


def chunk_of(plan: SymvPlan, b: int):
    """Block b's chunk, as csrc/symv.cu's `chunk_of` walks them (chunk c
    of every tile column, then chunk c + 1): (column J, chunk index c,
    first tile row, end tile row)."""
    c = 0
    while b >= plan.tiles - c * plan.chunk:
        b -= plan.tiles - c * plan.chunk
        c += 1
    i0 = b + c * plan.chunk
    return b, c, i0, min(i0 + plan.chunk, plan.tiles)


def fold_slots(plan: SymvPlan, i: int):
    """The scratch slots that output row i sums: the row products of
    tiles (I, 0..I), then the column products of column I's chunks. The
    fold adds entry q of this list into partial q % FOLD_WARPS, each in
    list order, then the partials in order."""
    it = i // TILE
    return list(range(it + 1)) + [
        plan.tiles + c for c in range(common.cdiv(plan.tiles - it,
                                                  plan.chunk))]


def symv_knobs(cfg):
    """The `symv_plan` keywords of a tile config (block_m: rows of a
    chunk), {} for None or a config without it."""
    if cfg is None or cfg.block_m is None:
        return {}
    return {"chunk_rows": cfg.block_m}


def footprint(itemsize: int, cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of symv's kernels, whatever the plan: the
    mainloop's TMA ring (STAGES tiles), its column-sum staging (16 x 64
    float32) and barriers; the fold's (8 x 32 float32) partials. The
    knob sets the grid, not the block."""
    return (common.Footprint(
        "symv_kernel/tma", STAGES * TILE * TILE * itemsize
        + 4 * (TILE // 4) * TILE + 8 * STAGES + common.STATIC_SLACK,
        4),
        common.Footprint("symv_fold_kernel",
                         4 * FOLD_WARPS * 32 + common.STATIC_SLACK))


def symv_route(a: torch.Tensor) -> str:
    """The route that loads A's tiles: "tma" where TMA takes A (base
    16-byte aligned, a row a multiple of 16 bytes: gemm's conditions on
    an operand), "ldg" otherwise."""
    return gemm.load_route(a, a)


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
def symv(alpha, a, x, beta, y, *, tiles=None):
    """y' = alpha S x + beta y, S the symmetric matrix in A's lower
    triangle; A (n, n), x and y (n,). `tiles`: a tile config for
    `symv_plan` (`symv_knobs`)."""
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
    common.check_contiguous(x, y)
    plan, route = symv_plan(n, **symv_knobs(tiles)), symv_route(a)
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    work = torch.empty((plan.slots, plan.pitch), dtype=torch.float32,
                       device=a.device)
    scal = common.scalar_block([alpha, beta], a.device)
    cuda.launch("symv", "repro_symv", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(y), cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal),
                n, plan.chunk, ROUTES.index(route))
    symv.launches += 1
    symv.route_launches[route] += 1
    symv.finish_launches += 1
    return out


symv.route_launches = dict.fromkeys(ROUTES, 0)   # launches per route


def product(a, x, tiles=None):
    """The raw float32 S x on the card (`repro_symv_acc`: symv's mainloop,
    then its fold with no alpha, beta or y): returns (acc (n,), route).
    Counted by the caller (the anchored generator), not by `symv`."""
    m, n = common.check_matrix(a)
    if m != n:
        raise ValueError(f"symv needs a square matrix, got {tuple(a.shape)}")
    if x.ndim != 1 or x.shape[0] != n or x.dtype != a.dtype:
        raise ValueError(f"S x with A {tuple(a.shape)} {a.dtype} needs x "
                         f"of length {n} in that dtype, got "
                         f"{tuple(x.shape)} {x.dtype}")
    common.check_contiguous(x)
    plan, route = symv_plan(n, **symv_knobs(tiles)), symv_route(a)
    acc = torch.empty(n, dtype=torch.float32, device=a.device)
    work = torch.empty((plan.slots, plan.pitch), dtype=torch.float32,
                       device=a.device)
    cuda.launch("symv", "repro_symv_acc", a, cuda.ptr(a), cuda.ptr(x),
                cuda.ptr(acc), cuda.ptr(work), n, plan.chunk,
                ROUTES.index(route))
    return acc, route
