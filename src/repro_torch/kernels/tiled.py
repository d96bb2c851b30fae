"""The tiled generator: a gemm anchor together with the panel routines
fused around its output tile, as the CUDA mainloop's product and one
generated Triton epilogue.

Replaces the Pallas kernel that `repro/core/codegen.py::
_build_tiled_kernel` (:782-891) builds and `make_tiled_callable`
launches (its `pallas_call` at codegen.py:934). The reference splices
the gemm kernel's block body into that kernel (`repro/kernels/gemm.py::
gemm_block`); here the contraction is the same CUDA mainloop as gemm's
(`csrc/gemm.cu`, entry `repro_gemm_acc`, launched by `gemm.product`),
which writes the raw float32 A B into scratch, and the generated kernel
finishes it. `core/codegen.py` splices the member routines' `tl`
templates (`colaxpy`, `coldot`, and any element-wise or additive
reduction template) into a `TiledBody`; `source` renders it as a Triton
module and `launch` runs the product and then that module:

* contraction — true float32 FFMA over A and B widened to float32,
  never TF32 (the reference product is `preferred_element_type=float32`
  on float32 inputs); split over K only where its output tiles leave
  most SMs idle, one float32 partial per split;
* epilogue — one program per (BM, BN) tile of the (m, n) output sums the
  partials in split order and forms yo = alpha acc + beta C (C is read
  even at beta 0, as in the reference), which feeds the spliced
  members: member panels arrive as (BM, BN) tiles, member vectors as
  (1, BN) rows that broadcast down the tile (`colaxpy`'s a x + y);
* outputs — element-wise results store masked tiles; each column
  reduction (`coldot`) writes one (1, BN) float32 partial per tile into
  an (NI, n) buffer and `colsum_kernel` folds the NI row tiles in a
  fixed order; additive scalar reductions write one partial per tile
  and window.py's `finish_kernel` folds them. No atomics, so a result
  repeats bitwise. Index reductions are refused, as in the reference
  (codegen.py:873-875).

The edge is masked, never padded: the reference pads A, B and C with
zeros (codegen.py:973-993), so its reductions also sum the padded rows.

Bound on an H100 SXM: at block-CG's shape (n = 16384, s = 32, float32)
BLOCK_CG_MATVEC must move 4 (n^2 + 2ns + s) bytes (A and P read, q and
pq written), 0.322 ms at 3.35 TB/s, just above its 2 n^2 s FFMA at 67
TFLOP/s (0.256 ms). The product streams A (1.07 GB); the epilogue moves
a few MB (the 2 MB accumulator, C, the member panels and the outputs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import common, gemm, window

BM = 64               # output rows per epilogue program
MIN_BN, MAX_BN = 16, 64
NUM_WARPS = 4
FOLD_ROWS, FOLD_COLS = 64, 32   # partials per step of colsum_kernel


@dataclasses.dataclass(frozen=True)
class TiledBody:
    """What one tiled kernel computes.

    Names inside the statements: `s0, s1, ...` are the float32 scalars,
    `yo` the anchor's finished (BM, BN) tile, `m0, m1, ...` the member
    panel tiles and `v0, v1, ...` the member vectors as (1, BN) rows,
    all widened to float32."""
    n_scalars: int
    n_mats: int
    n_cols: int
    alpha: str                        # scalar variables of the anchor
    beta: str
    post: Tuple[str, ...] = ()        # `name = expression` statements
    stores: Tuple[str, ...] = ()      # one (m, n) output each
    # (per-element term, post function or None): column reductions
    # and whole-tile scalar reductions
    colsums: Tuple[Tuple[str, Optional[str]], ...] = ()
    sums: Tuple[Tuple[str, Optional[str]], ...] = ()
    # always empty (codegen refuses index reductions); window.py's
    # reduction helpers read it
    argmaxes: Tuple[str, ...] = ()


def block_n(n: int) -> int:
    """Output columns per epilogue program: n rounded up to a power of
    two, in [MIN_BN, MAX_BN]; the columns past n are masked."""
    bn = MIN_BN
    while bn < n and bn < MAX_BN:
        bn *= 2
    return bn


def footprint(body: TiledBody, itemsize: int,
              cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of a tiled group's kernels under `cfg`:
    the product's (`gemm.footprint`), then the epilogue's (an estimate:
    Triton allocates it): each column and scalar reduction's cross-warp
    step over a (BM, MAX_BN) tile, at most twice a float32 per column
    and warp, and at least one such staging; the folds' the same over
    their blocks (chip_smoke.py reads each compiled variant's request:
    256-512 bytes)."""
    per = max(1, len(body.colsums) + len(body.sums))
    out = gemm.footprint(itemsize, cfg) + (
        common.Footprint("tiled_kernel", 4 * 2 * MAX_BN * NUM_WARPS * per),)
    if body.colsums:
        out += (common.Footprint("colsum_kernel", 4 * 2 * FOLD_COLS * 4),)
    if body.sums:
        out += (common.Footprint("finish_kernel", 4 * 32 * 4
                                 * len(body.sums)),)
    return out


def source(body: TiledBody) -> str:
    """The Triton module (`tiled_kernel`, the epilogue over the
    product's float32 partials, plus `colsum_kernel` and `finish_kernel`
    when the body reduces) for one tiled group."""
    ns = body.n_scalars
    params = (["scal_ptr"] if ns else []) + ["acc_ptr", "c_ptr"] \
        + [f"m{i}_ptr" for i in range(body.n_mats)] \
        + [f"v{i}_ptr" for i in range(body.n_cols)] \
        + [f"o{i}_ptr" for i in range(len(body.stores))] \
        + (["pcol_ptr"] if body.colsums else []) \
        + (["psum_ptr"] if body.sums else [])
    out = window.HEADER + [
        "@triton.jit",
        f"def tiled_kernel({', '.join(params)}, M, N, S, PLANE, NI, P, "
        "BM: tl.constexpr, BN: tl.constexpr):",
        "    pid_m = tl.program_id(0)",
        "    pid_n = tl.program_id(1)",
        "    pid = pid_m * tl.num_programs(1) + pid_n",
        "    rows = pid_m * BM + tl.arange(0, BM)",
        "    cols = pid_n * BN + tl.arange(0, BN)",
        "    rmask = rows < M",
        "    cmask = cols < N",
        "    mask = rmask[:, None] & cmask[None, :]",
        "    offs = rows.to(tl.int64)[:, None] * N + cols[None, :]",
        "    ptrs = acc_ptr + offs",
        "    acc = tl.load(ptrs, mask=mask, other=0.0)",
        "    for split in range(1, S):   # the K splits, in order",
        "        ptrs += PLANE",
        "        acc += tl.load(ptrs, mask=mask, other=0.0)",
    ]
    out += [f"    s{i} = tl.load(scal_ptr + {i})" for i in range(ns)]
    out += [f"    yo = {body.alpha} * acc + {body.beta} * tl.load(c_ptr"
            " + offs, mask=mask, other=0.0).to(tl.float32)"]
    out += [f"    m{i} = tl.load(m{i}_ptr + offs, mask=mask, other=0.0)"
            f".to(tl.float32)" for i in range(body.n_mats)]
    out += [f"    v{i} = tl.load(v{i}_ptr + cols, mask=cmask, other=0.0)"
            f".to(tl.float32)[None, :]" for i in range(body.n_cols)]
    out += [f"    {line}" for line in body.post]
    for i, expr in enumerate(body.stores):
        out.append(f"    tl.store(o{i}_ptr + offs, ({expr})"
                   f".to(o{i}_ptr.dtype.element_ty), mask=mask)")
    for r, (term, _) in enumerate(body.colsums):
        out.append(f"    tl.store(pcol_ptr + ({r} * NI + pid_m) * N + cols, "
                   f"tl.sum(tl.where(mask, {term}, 0.0), axis=0), "
                   f"mask=cmask)")
    for r, (term, _) in enumerate(body.sums):
        out.append(f"    tl.store(psum_ptr + {r} * P + pid, tl.sum(tl.sum("
                   f"tl.where(mask, {term}, 0.0), axis=1), axis=0))")
    out += colsum_source(body)
    out += window.finish_source(body)
    return "\n".join(out) + "\n"


def colsum_source(body: TiledBody):
    """`colsum_kernel`: fold the (NI, n) column partials of each column
    reduction in a fixed order, FOLD_COLS columns per program."""
    if not body.colsums:
        return []
    out = [
        "",
        "",
        "@triton.jit",
        "def colsum_kernel(pcol_ptr, ocol_ptr, NI, N, "
        "IB: tl.constexpr, CB: tl.constexpr):",
        "    cols = tl.program_id(0) * CB + tl.arange(0, CB)",
        "    cmask = cols < N",
        "    lanes = tl.arange(0, IB)",
    ]
    for r, (_, post) in enumerate(body.colsums):
        total = f"tl.sum(acc{r}, axis=0)"
        out += [
            f"    acc{r} = tl.zeros([IB, CB], dtype=tl.float32)",
            "    for start in range(0, NI, IB):",
            "        i = start + lanes",
            f"        acc{r} += tl.load(pcol_ptr + ({r} * NI + i[:, None])"
            f" * N + cols[None, :], mask=(i < NI)[:, None]"
            f" & cmask[None, :], other=0.0)",
            f"    tl.store(ocol_ptr + {r} * N + cols, "
            f"{f'{post}({total})' if post else total}, mask=cmask)",
        ]
    return out


_MODULES: dict = {}


def load(body: TiledBody):
    """The imported Triton module for `body`, built once per process."""
    mod = _MODULES.get(body)
    if mod is None:
        mod = common.load_source("tiled_gemm", source(body))
        _MODULES[body] = mod
    return mod


def launch(body: TiledBody, scalars: Optional[torch.Tensor],
           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           mats: Sequence[torch.Tensor], cols: Sequence[torch.Tensor],
           out_dtype: torch.dtype, tiles=None):
    """Run one tiled group on the card: A (m, k), B (k, n), C (m, n),
    the member panels (m, n) and vectors (n,) in body order; `tiles`
    sets the product's plan (`gemm.gemm_knobs`).

    Returns (element-wise (m, n) outputs, (len(colsums), n) float32
    column results or None, (len(sums),) float32 results or None,
    number of fold launches, the product's route)."""
    for t in (a, b, c, *mats, *cols):
        if not t.is_contiguous():
            raise ValueError("tiled kernels take contiguous operands")
    mod = load(body)
    m, n = c.shape
    acc, route = gemm.product(a, b, tiles)
    bn = block_n(n)
    ni, nj = common.cdiv(m, BM), common.cdiv(n, bn)
    p = ni * nj
    dev = a.device
    outs = [torch.empty((m, n), dtype=out_dtype, device=dev)
            for _ in body.stores]
    nc = len(body.colsums)
    pcol = colres = None
    if nc:
        pcol = torch.empty((nc, ni, n), dtype=torch.float32, device=dev)
        colres = torch.empty((nc, n), dtype=torch.float32, device=dev)
    partials, finals, sums, _ = window.reduction_buffers(body, p, dev)
    args = ([scalars] if body.n_scalars else []) + [acc, c, *mats, *cols,
                                                    *outs]
    args += ([pcol] if nc else []) + partials
    mod.tiled_kernel[(ni, nj)](*args, m, n, acc.shape[0], m * n, ni, p,
                               BM=BM, BN=bn, num_warps=NUM_WARPS)
    folds = 0
    if nc:
        mod.colsum_kernel[(common.cdiv(n, FOLD_COLS),)](
            pcol, colres, ni, n, IB=FOLD_ROWS, CB=FOLD_COLS, num_warps=4)
        folds += 1
    folds += window.finish(mod, body, finals, p)
    return outs, colres, sums, folds, route
