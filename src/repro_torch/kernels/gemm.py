"""BLAS level-3 gemm (C' = alpha A B + beta C) for Hopper, in CUDA C++
(`csrc/gemm.cu`), and matmul (C = A B) on top of it.

Replaces `repro/kernels/gemm.py::gemm` (its `pallas_call` at gemm.py:69)
and `::matmul` (:91). As there, A and B are widened to float32 and the
product accumulates in float32 (no TF32), alpha and beta are float32,
`beta * C` is computed even when beta is 0, and the result is rounded
once to C's dtype. The three operands share one dtype here: every
program hands the kernel its own dtype.

The same mainloop gives the tiled generator its product: `product`
launches it for the raw float32 A B, uncounted here, and
`kernels/tiled.py` finishes the tile.

Bound on an H100 SXM at block-CG's shape (16384 x 16384) . (16384 x
32) float32: the bytes, 4 (n^2 + 3ns) at 3.35 TB/s = 0.322 ms, just
above the float32 FFMA time, 2 n^2 s at 67 TFLOP/s = 0.256 ms. The
kernel design is described in csrc/gemm.cu; the tile width, the split
of K where the output tiles leave most SMs idle, and the route are
chosen here.

Tuning knobs (`tune.TileConfig`, family `gemm`; `gemm_knobs`):
`block_n` sets the tile width (the narrowest of WIDTHS that holds it)
and `block_k` the K of a split (whole stages); BM = 128 rows, the ring
(csrc/gemm.cu kRingBytes) and the warp roles are constants of the
source and are not swept. A split of K sums its partials in split
order, another order than the default plan's: the result agrees with
it within tolerance, not bitwise.
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
ROUTES = ("tma", "ldg")     # C route codes 0 and 1
RING_BYTES = 200 * 1024     # csrc/gemm.cu kRingBytes
MAX_STAGES = 8              # csrc/gemm.cu kMaxStages


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    bn: int        # output columns per block
    splits: int    # chunks of K, one per grid.z
    chunk: int     # K per chunk, a whole number of stages


def block_n(n: int) -> int:
    """Output columns per block: the narrowest width that covers n, or
    the widest."""
    return next((w for w in WIDTHS if n <= w), WIDTHS[-1])


def block_k(itemsize: int) -> int:
    """K per stage: one 128-byte row of A (32 float32, 64 16-bit)."""
    return ROW_BYTES // itemsize


def gemm_plan(m: int, n: int, k: int, itemsize: int, sms: int,
              width: Optional[int] = None,
              split_k: Optional[int] = None) -> GemmPlan:
    """The launch of an (m, k) . (k, n) product on a card of `sms` SMs.
    K is split only where the output tiles leave most SMs idle (fewer
    tiles than half the SMs, as in a short, wide product with a long K),
    into as many chunks as fill the SMs once, none shorter than
    MIN_K_PER_SPLIT, each a whole number of stages. A tuned plan sets
    the tile width (`width`, one of WIDTHS) and the K of a split
    (`split_k`, rounded up to whole stages)."""
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


def footprint(itemsize: int, cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of gemm's kernels under `cfg`, for any
    shape: the mainloop's ring at the widest width the plan may take
    (one block per SM by design: the ring fills shared memory), and the
    split combine's none."""
    width = gemm_knobs(cfg).get("width")
    widths = WIDTHS if width is None else (width,)
    return (common.Footprint(
        "gemm_kernel", max(smem_bytes(w, itemsize) for w in widths)
        + common.STATIC_SLACK, 1),
        common.Footprint("combine_kernel", common.STATIC_SLACK))


def gemm_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route that loads the stages: "tma" where TMA takes A and B
    (bases 16-byte aligned, rows of k and n elements whole multiples of
    16 bytes), "ldg" otherwise. Shapes, dtypes and addresses only: it
    also answers for CPU tensors."""
    size = a.element_size()
    if (a.data_ptr() % 16 or b.data_ptr() % 16 or a.shape[1] * size % 16
            or b.shape[1] * size % 16):
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


def plan_for(a, b, tiles=None) -> GemmPlan:
    (m, k), n = a.shape, b.shape[1]
    return gemm_plan(m, n, k, a.element_size(), common.sm_count(a.device),
                     **gemm_knobs(tiles))


def product(a, b, tiles=None):
    """The raw float32 product A B on the card, one (m, n) partial per
    split of K: returns (partials (splits, m, n), route). Counted by the
    caller (the tiled generator), not by `gemm`."""
    (m, k), n = a.shape, b.shape[1]
    plan, route = plan_for(a, b, tiles), gemm_route(a, b)
    acc = torch.empty((plan.splits, m, n), dtype=torch.float32,
                      device=a.device)
    cuda.launch("gemm", "repro_gemm_acc", a, cuda.ptr(a), cuda.ptr(b),
                cuda.ptr(acc), m, n, k, plan.bn, plan.chunk, plan.splits,
                ROUTES.index(route))
    return acc, route


@common.counted
def gemm(alpha, a, b, beta, c, *, tiles=None):
    """C' = alpha A B + beta C for A (m, k), B (k, n), C (m, n).
    `tiles`: a tile config for `gemm_plan` (`gemm_knobs`)."""
    m, n, k = check_operands(a, b, c)
    if not common.on_card(a, b, c):
        gemm.plain_calls += 1
        return gemm_plain(alpha, a, b, beta, c)
    plan, route = plan_for(a, b, tiles), gemm_route(a, b)
    out = torch.empty((m, n), dtype=c.dtype, device=c.device)
    work = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                        device=c.device) if plan.splits > 1 else None)
    scal = common.scalar_block([alpha, beta], c.device)
    cuda.launch("gemm", "repro_gemm", c, cuda.ptr(a), cuda.ptr(b),
                cuda.ptr(c), cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal),
                m, n, k, plan.bn, plan.chunk, plan.splits,
                ROUTES.index(route))
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
