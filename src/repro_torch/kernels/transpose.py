"""Matrix transpose (out = Aᵀ) for Hopper, in CUDA C++
(`csrc/transpose.cu`).

Replaces `repro/kernels/transpose.py::transpose` (its `pallas_call` at
transpose.py:38). GMRES runs it once per restart to turn its stack of
Hessenberg columns, an (m, m + 1) buffer, into the (m + 1, m) rows its
Givens sweep rotates. The output is a new row-major tensor in A's dtype,
bitwise equal to `A.t()`.

Bound on an H100 SXM: HBM bytes, 2 · itemsize · m · n (0.641 ms for a
16384 x 16384 float32 A). The kernel's shared-memory tiles are
described in csrc/transpose.cu.
"""
from __future__ import annotations

import torch

from . import common, cuda


TILE = 32           # csrc/transpose.cu kTile


def footprint(itemsize: int):
    """Shared memory per block: one (TILE, TILE + 1) tile of A's dtype;
    no tuning knob."""
    return (common.Footprint(
        "transpose_kernel",
        TILE * (TILE + 1) * itemsize + common.STATIC_SLACK),)


def transpose_plain(a):
    """Aᵀ as a new row-major tensor."""
    return a.t().clone(memory_format=torch.contiguous_format)


@common.counted
def transpose(a):
    """out = Aᵀ for A (m, n): a new (n, m) tensor in A's dtype."""
    m, n = common.check_matrix(a)
    if not common.on_card(a):
        transpose.plain_calls += 1
        return transpose_plain(a)
    out = torch.empty((n, m), dtype=a.dtype, device=a.device)
    cuda.launch("transpose", "repro_transpose", a, cuda.ptr(a),
                cuda.ptr(out), m, n)
    transpose.launches += 1
    return out
