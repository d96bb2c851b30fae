"""BLAS level-3 gemm (C' = alpha A B + beta C) for Hopper, in CUDA C++
(`csrc/gemm.cu`), and matmul (C = A B) on top of it.

Replaces `repro/kernels/gemm.py::gemm` (its `pallas_call` at gemm.py:69)
and `::matmul` (:91). As there, A and B are widened to float32 and the
product accumulates in float32 (no TF32), alpha and beta are float32,
`beta * C` is computed even when beta is 0, and the result is rounded
once to C's dtype. The three operands share one dtype here: every
program hands the kernel its own dtype.

Two mainloops (routes): bfloat16 and float16 operands that TMA takes
run on the tensor cores ("wgmma", `gemm_wgmma_kernel`); float32 and
misaligned 16-bit operands run the float32 FFMA mainloop, loading
their stages by TMA ("tma") or by ordinary loads ("ldg"). float32 never
takes wgmma: its wgmma is TF32. The same route choice gives the tiled
generator its product: `product` launches the route's mainloop for the
raw float32 A B, uncounted here, and `kernels/tiled.py` finishes the
tile.

Bound on an H100 SXM at block-CG's shape (16384 x 16384) . (16384 x
32) float32: the bytes, 4 (n^2 + 3ns) at 3.35 TB/s = 0.322 ms, just
above the float32 FFMA time, 2 n^2 s at 67 TFLOP/s = 0.256 ms. At
4096^3 bfloat16 on the wgmma route: 2 n^3 at 989 TFLOP/s = 0.139 ms.
The kernels' design is described in csrc/gemm.cu; the tile, the split
of K where the output tiles leave SMs idle, and the route are chosen
here.

Tuning knobs (`tune.TileConfig`, family `gemm`; `gemm_knobs`):
`block_n` sets the tile width (the narrowest of WIDTHS that holds it;
on the wgmma route the narrowest of WG_WIDTHS that holds that) and
`block_k` the K of a split (whole stages of the route); BM (128 on
the FFMA routes, 64 or 128 after m on wgmma), the rings and the warp
roles are constants of the source and are not swept. A split of K
sums its partials in split order, another order than the default
plan's: the result agrees with it within tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import common, cuda

BM = 128                    # output rows per block of csrc/gemm.cu
ROW_BYTES = 128             # K bytes of one row of A per stage
WIDTHS = (32, 64, 128)      # output columns per block, after n
MIN_K_PER_SPLIT = 512
ROUTES = ("tma", "ldg", "wgmma")   # repro_gemm's route codes 0 and 1;
                                   # wgmma has entries of its own
RING_BYTES = 200 * 1024     # csrc/gemm.cu kRingBytes
MAX_STAGES = 8              # csrc/gemm.cu kMaxStages
WG_WIDTHS = (64, 128)       # wgmma route: output columns per block
WG_BK = 64                  # wgmma route: K per stage (128 bytes)
WG_MIN_K_PER_SPLIT = 256    # wgmma route: four stages


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    bn: int        # output columns per block
    splits: int    # chunks of K, one per grid.z
    chunk: int     # K per chunk, a whole number of stages
    bm: int = BM   # output rows per block


def block_n(n: int) -> int:
    """Output columns per block: the narrowest width that covers n, or
    the widest."""
    return next((w for w in WIDTHS if n <= w), WIDTHS[-1])


def block_k(itemsize: int) -> int:
    """K per stage: one 128-byte row of A (32 float32, 64 16-bit)."""
    return ROW_BYTES // itemsize


def gemm_plan(m: int, n: int, k: int, itemsize: int, sms: int,
              width: Optional[int] = None,
              split_k: Optional[int] = None,
              route: str = "tma") -> GemmPlan:
    """The launch of an (m, k) . (k, n) product on a card of `sms` SMs,
    on `route` (`wgmma_plan` for "wgmma"). K is split only where the
    output tiles leave most SMs idle (fewer tiles than half the SMs, as
    in a short, wide product with a long K), into as many chunks as fill
    the SMs once, none shorter than MIN_K_PER_SPLIT, each a whole number
    of stages. A tuned plan sets the tile width (`width`, one of WIDTHS)
    and the K of a split (`split_k`, rounded up to whole stages)."""
    if route == "wgmma":
        return wgmma_plan(m, n, k, sms, width, split_k)
    bn, bk = block_n(n) if width is None else width, block_k(itemsize)
    if bn not in WIDTHS:
        raise ValueError(f"gemm tile width {bn}: one of {WIDTHS}")
    if split_k is not None:
        chunk = common.cdiv(min(split_k, k), bk) * bk
        return GemmPlan(bn, common.cdiv(k, chunk), chunk)
    tiles = common.cdiv(m, BM) * common.cdiv(n, bn)
    splits = 1
    if 2 * tiles < sms:
        splits = max(1, min(sms // tiles, k // MIN_K_PER_SPLIT))
    chunk = common.cdiv(common.cdiv(k, splits), bk) * bk
    return GemmPlan(bn, common.cdiv(k, chunk), chunk)


def wg_width(n: int) -> int:
    """Output columns per block on the wgmma route: the narrowest of
    WG_WIDTHS that covers n, or the widest."""
    return next((w for w in WG_WIDTHS if n <= w), WG_WIDTHS[-1])


def wgmma_plan(m: int, n: int, k: int, sms: int,
               width: Optional[int] = None,
               split_k: Optional[int] = None) -> GemmPlan:
    """The wgmma route's launch of an (m, k) . (k, n) 16-bit product:
    64-row tiles where m <= 64 (a decode projection), else 128; 64
    columns where n (or a tuned `width`, one of WIDTHS) is at most 64,
    else 128. K is split where the tiles leave SMs idle, into as many
    chunks as give every SM a block, none shorter than
    WG_MIN_K_PER_SPLIT, each a whole number of 64-deep stages: a skinny
    product is bound by the bytes of B and needs every SM's loads in
    flight. A tuned plan's `split_k` is rounded up to whole stages."""
    if width is not None and width not in WIDTHS:
        raise ValueError(f"gemm tile width {width}: one of {WIDTHS}")
    bm = 64 if m <= 64 else 128
    bn = wg_width(n if width is None else width)
    if split_k is not None:
        chunk = common.cdiv(min(split_k, k), WG_BK) * WG_BK
        return GemmPlan(bn, common.cdiv(k, chunk), chunk, bm)
    tiles = common.cdiv(m, bm) * common.cdiv(n, bn)
    splits = 1
    if tiles < sms:
        splits = max(1, min(common.cdiv(sms, tiles),
                            k // WG_MIN_K_PER_SPLIT))
    chunk = common.cdiv(common.cdiv(k, splits), WG_BK) * WG_BK
    return GemmPlan(bn, common.cdiv(k, chunk), chunk, bm)


def gemm_knobs(cfg):
    """The `gemm_plan` keywords of a tile config (block_n: the narrowest
    width of WIDTHS that holds it; block_k: K per split), {} for None."""
    if cfg is None:
        return {}
    out = {}
    if cfg.block_n is not None:
        out["width"] = block_n(cfg.block_n)
    if cfg.block_k is not None:
        out["split_k"] = cfg.block_k
    return out


def smem_bytes(width: int, itemsize: int) -> int:
    """Dynamic shared memory of one gemm block at a tile width, as
    csrc/gemm.cu's GemmTile sizes it: 1 KiB of alignment, as many
    stages of A (BM x 128 bytes) and B (a stage's K x width) as fit
    RING_BYTES (at most MAX_STAGES), and two barriers a stage."""
    stage = BM * ROW_BYTES + block_k(itemsize) * width * itemsize
    stages = min(RING_BYTES // stage, MAX_STAGES)
    return 1024 + stages * stage + 2 * stages * 8


def wg_smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of one block of the wgmma route, as
    csrc/gemm.cu's WgGemmTile sizes it: 1 KiB of alignment, as many
    stages of A (bm x 128 bytes) and B (64 x bn 16-bit) as fit its ring
    (96 KiB at bm 64, two blocks an SM; 192 KiB at bm 128), at most
    MAX_STAGES, and two barriers a stage."""
    stage = bm * ROW_BYTES + WG_BK * bn * 2
    ring = (96 if bm == 64 else 192) * 1024
    stages = min(ring // stage, MAX_STAGES)
    return 1024 + stages * stage + 2 * stages * 8


def footprint(itemsize: int, cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of gemm's kernels under `cfg`, for any
    shape: the FFMA mainloop's ring at the widest width the plan may
    take (one block per SM by design: the ring fills shared memory), the
    split combine's none, and for 16-bit operands the wgmma mainloop's
    at the widest tile the plan may take (bm 128: one block an SM)."""
    width = gemm_knobs(cfg).get("width")
    widths = WIDTHS if width is None else (width,)
    out = (common.Footprint(
        "gemm_kernel", max(smem_bytes(w, itemsize) for w in widths)
        + common.STATIC_SLACK, 1),
        common.Footprint("combine_kernel", common.STATIC_SLACK))
    if itemsize == 2:
        wg = WG_WIDTHS if width is None else (wg_width(width),)
        out += (common.Footprint(
            "gemm_wgmma_kernel", max(wg_smem_bytes(128, w) for w in wg)
            + common.STATIC_SLACK, 1),)
    return out


def shape_route(k: int, n: int, itemsize: int) -> str:
    """The route of A (m, k) . B (k, n) at 16-byte aligned bases: where
    TMA takes the operands (rows of k and n elements whole multiples of
    16 bytes) "wgmma" for 16-bit ones and "tma" for float32 ones, "ldg"
    otherwise."""
    if k * itemsize % 16 or n * itemsize % 16:
        return "ldg"
    return "wgmma" if itemsize == 2 else "tma"


def gemm_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route of A B: "wgmma" for bfloat16 and float16 operands that
    TMA takes, "tma" for such float32 ones, "ldg" for the rest (a base
    off 16 bytes, or rows that are not whole multiples of 16 bytes).
    Shapes, dtypes and addresses only: it also answers for CPU
    tensors."""
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        return "ldg"
    return shape_route(a.shape[1], b.shape[1], a.element_size())


def load_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """"tma" where TMA takes A and B (gemm's conditions), "ldg"
    otherwise: how the FFMA mainloop, gemv's and symv's kernels load
    their operands."""
    if a.data_ptr() % 16 or b.data_ptr() % 16 or shape_route(
            a.shape[1], b.shape[1], a.element_size()) == "ldg":
        return "ldg"
    return "tma"


# ---------------------------------------------------------------------------
# Plain version (float32 product, one rounding to C's dtype)
# ---------------------------------------------------------------------------


def gemm_acc(a, b):
    """A B in float32: the anchor's product, before alpha and beta."""
    return a.float() @ b.float()


def gemm_plain(alpha, a, b, beta, c):
    s = common.scalar_block([alpha, beta], a.device)
    return (s[0] * gemm_acc(a, b) + s[1] * c.float()).to(c.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def check_operands(a, b, c):
    """Validate gemm's operands; returns (m, n, k)."""
    m, k = common.check_matrix(a)
    k2, n = common.check_matrix(b)
    if k2 != k or common.check_matrix(c) != (m, n):
        raise ValueError(f"gemm needs A (m, k), B (k, n) and C (m, n); got "
                         f"A {tuple(a.shape)}, B {tuple(b.shape)}, C "
                         f"{tuple(c.shape)}")
    if not a.dtype == b.dtype == c.dtype:
        raise ValueError(f"operand dtypes disagree: A {a.dtype}, B "
                         f"{b.dtype}, C {c.dtype}")
    return m, n, k


def plan_for(a, b, tiles=None, route=None) -> GemmPlan:
    (m, k), n = a.shape, b.shape[1]
    return gemm_plan(m, n, k, a.element_size(), common.sm_count(a.device),
                     **gemm_knobs(tiles),
                     route=route or gemm_route(a, b))


def product(a, b, tiles=None):
    """The raw float32 product A B on the card, one (m, n) partial per
    split of K, on `gemm_route`'s route: returns (partials (splits, m,
    n), route). Counted by the caller (the tiled generator), not by
    `gemm`."""
    (m, k), n = a.shape, b.shape[1]
    route = gemm_route(a, b)
    plan = plan_for(a, b, tiles, route)
    acc = torch.empty((plan.splits, m, n), dtype=torch.float32,
                      device=a.device)
    if route == "wgmma":
        cuda.launch("gemm", "repro_gemm_wgmma_acc", a, cuda.ptr(a),
                    cuda.ptr(b), cuda.ptr(acc), m, n, k, plan.bm, plan.bn,
                    plan.chunk, plan.splits)
    else:
        cuda.launch("gemm", "repro_gemm_acc", a, cuda.ptr(a), cuda.ptr(b),
                    cuda.ptr(acc), m, n, k, plan.bn, plan.chunk,
                    plan.splits, ROUTES.index(route))
    return acc, route


@common.counted
def gemm(alpha, a, b, beta, c, *, tiles=None):
    """C' = alpha A B + beta C for A (m, k), B (k, n), C (m, n).
    `tiles`: a tile config for `gemm_plan` (`gemm_knobs`)."""
    m, n, k = check_operands(a, b, c)
    if not common.on_card(a, b, c):
        gemm.plain_calls += 1
        return gemm_plain(alpha, a, b, beta, c)
    route = gemm_route(a, b)
    plan = plan_for(a, b, tiles, route)
    out = torch.empty((m, n), dtype=c.dtype, device=c.device)
    work = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                        device=c.device) if plan.splits > 1 else None)
    scal = common.scalar_block([alpha, beta], c.device)
    ptrs = (cuda.ptr(a), cuda.ptr(b), cuda.ptr(c), cuda.ptr(out),
            cuda.ptr(work), cuda.ptr(scal))
    if route == "wgmma":
        cuda.launch("gemm", "repro_gemm_wgmma", c, *ptrs, m, n, k, plan.bm,
                    plan.bn, plan.chunk, plan.splits)
    else:
        cuda.launch("gemm", "repro_gemm", c, *ptrs, m, n, k, plan.bn,
                    plan.chunk, plan.splits, ROUTES.index(route))
    gemm.launches += 1
    gemm.route_launches[route] += 1
    gemm.finish_launches += plan.splits > 1
    return out


gemm.route_launches = dict.fromkeys(ROUTES, 0)   # launches per route


def matmul(a, b):
    """C = A B through the gemm kernel (alpha = 1, beta = 0), as the
    reference's matmul does."""
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                    device=a.device)
    return gemm(1.0, a, b, 0.0, c)
