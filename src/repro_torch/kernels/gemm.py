"""BLAS level-3 gemm (C' = alpha A B + beta C) for Hopper, in CUDA C++
(`csrc/gemm.cu`), and matmul (C = A B) on top of it.

Replaces `repro/kernels/gemm.py::gemm` (its `pallas_call` at gemm.py:69)
and `::matmul` (:91). As there, A and B are widened to float32 and the
product accumulates in float32 (no TF32), alpha and beta are float32,
`beta * C` is computed even when beta is 0, and the result is rounded
once to C's dtype. The three operands share one dtype here: every
program hands the kernel its own dtype.

Bound on an H100 SXM at block-CG's shape (16384 x 16384) . (16384 x
32) float32: the bytes, 4 (n^2 + 3ns) at 3.35 TB/s = 0.322 ms, just
above the float32 FFMA time, 2 n^2 s at 67 TFLOP/s = 0.256 ms. The
kernel design is described in csrc/gemm.cu; the split of K that keeps
enough blocks in flight on a tall, skinny product, and the float32
scratch of its partials, are chosen here.
"""
from __future__ import annotations

import torch

from . import common, cuda

BM, BN, BK = 64, 32, 32     # output tile and K step of csrc/gemm.cu
# blocks that fill the card once: 132 SMs x 8 resident 128-thread blocks
TARGET_BLOCKS = 132 * 8
MIN_K_PER_SPLIT = 512


def gemm_plan(m: int, n: int, k: int):
    """(splits, K per split) of a gemm launch: K is cut when the output
    tiles alone do not fill the card, into chunks of whole K steps, and
    never into more chunks than one wave of blocks holds."""
    tiles = common.cdiv(m, BM) * common.cdiv(n, BN)
    splits = max(1, min(TARGET_BLOCKS // tiles, k // MIN_K_PER_SPLIT))
    chunk = common.cdiv(common.cdiv(k, splits), BK) * BK
    return common.cdiv(k, chunk), chunk


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


@common.counted
def gemm(alpha, a, b, beta, c):
    """C' = alpha A B + beta C for A (m, k), B (k, n), C (m, n)."""
    m, n, k = check_operands(a, b, c)
    if not common.on_card(a, b, c):
        gemm.plain_calls += 1
        return gemm_plain(alpha, a, b, beta, c)
    splits, chunk = gemm_plan(m, n, k)
    out = torch.empty((m, n), dtype=c.dtype, device=c.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=c.device) if splits > 1 else None)
    scal = common.scalar_block([alpha, beta], c.device)
    cuda.launch("gemm", "repro_gemm", c, cuda.ptr(a), cuda.ptr(b),
                cuda.ptr(c), cuda.ptr(out), cuda.ptr(work), cuda.ptr(scal),
                m, n, k, chunk, splits)
    gemm.launches += 1
    gemm.finish_launches += splits > 1
    return out


def matmul(a, b):
    """C = A B through the gemm kernel (alpha = 1, beta = 0), as the
    reference's matmul does."""
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                    device=a.device)
    return gemm(1.0, a, b, 0.0, c)
