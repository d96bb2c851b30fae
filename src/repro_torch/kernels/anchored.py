"""The anchored-group generator: a gemv, gemvt or symv anchor together with
the level-1 routines fused around it.

Replaces the Pallas kernel that `repro/core/codegen.py::
_build_anchored_kernel` (:463-592) builds and `make_anchored_callable`
launches (its `pallas_call` at codegen.py:655). `core/codegen.py`
splices the member routines' `tl` templates (the same ones the level-1
generator and the standalone kernels use) into an `AnchoredBody`;
`source` renders it as a Triton module and `launch` runs it. On the TPU
the grid's reduction axis ran in order and carried the accumulator in
VMEM scratch from step to step. Here each anchor kind has a route:

* gemv anchor — one Triton kernel. One program owns BO rows of A:
  - row phase: load the output-aligned vectors once, run the `pre`
    members (producers of the anchor's y);
  - matrix walk: stream A in (BO, BR) tiles against x, accumulating
    float32 products element-wise in registers and summing them once
    after the loop (`tl.dot` is not used: it needs dimensions of at
    least 16 and runs float32 in TF32, and a matvec is bound by bytes);
  - finish phase: y' = alpha acc + beta y, the `post` members on the
    finished block, the element-wise stores, and one partial per
    reduction per program, which `finish_kernel` (window.py) combines
    in a fixed order.
  It stays one launch: the CG iterations that run it are paced by the
  host, and a product launch through ctypes costs more host time than
  the kernel, at 90% of its bound, could gain (PERF.md §6).
* symv and gemvt anchors — the product on the standalone kernel's CUDA
  mainloop, as the raw float32 vector (`symv.product`: csrc/symv.cu's
  `repro_symv_acc`, each lower-triangle tile read once for both of its
  products; `gemv.gemvt_product`: csrc/gemv.cu's `repro_gemvt_acc`, row
  splits folded in a thread-block cluster), then the generated epilogue:
  a window pass (window.py) over the output-aligned vectors and that
  vector, whose programs run the `pre` members, form yo = alpha acc +
  beta y, run the `post` members, store, and write one partial per
  reduction, which the walk's last program combines. There is no
  matrix walk in Triton. The symv product keeps symv's own fold into
  the raw vector (launched in the same C call, so no host issue):
  folding the slots in the epilogue would repeat the fold's fixed
  order in a second place to save one n-float round trip (128 KB at
  n = 16384 beside the triangle's 537 MB).

The ragged edge is masked and kept out of every reduction (the
reference pads it, ROADMAP Queue 3).

Bound on an H100 SXM: HBM bytes, the matrix (or symv's lower triangle)
read once plus the group's vectors (CG_MATVEC at n = 16384 float32:
4(n² + 2n) bytes, 0.32 ms).

Tuning knobs (`tune.TileConfig`; `launch(tiles=)`): the gemv anchor's
`block_m` and `block_n` set BO and BR (family `gemv`), constexprs of
the kernel, so each pair compiles its own; a symv or gemvt anchor hands
its config to its product's plan (`symv.symv_knobs`, family `symv`;
`gemv.gemvt_knobs`, family `gemv`). The epilogue's walk keeps its
default step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import common, gemv, symv, window

# the gemv anchor's kernel: (BO output rows per program, BR columns per
# loop step, warps)
BLOCKS = {"gemv": (32, 128, 4)}
MAX_TILE = 8192     # the gemv anchor's (BO, BR) accumulators, at most
NUM_STAGES = 3
# anchors whose product runs on a CUDA mainloop, and the counted routes
# of those products
PRODUCTS = ("symv", "gemvt")
ROUTES = tuple(f"{anchor}/{route}" for anchor in PRODUCTS
               for route in symv.ROUTES)


@dataclasses.dataclass(frozen=True)
class AnchoredBody:
    """What one anchored kernel computes.

    Names inside the statements: `s0, s1, ...` are the float32 scalars,
    `x0, x1, ...` the output-aligned input blocks widened to float32,
    `xc` the reduction-axis vector (inside the gemv anchor's matrix walk
    only), `yo` the anchor's finished output block, and `offs` the
    global output indices of the block."""
    anchor: str                       # "gemv" | "gemvt" | "symv"
    n_scalars: int
    n_inputs: int
    alpha: str                        # scalar variables of the anchor
    beta: str
    rows: str                         # the anchor's y operand
    pre: Tuple[str, ...] = ()         # row phase statements
    post: Tuple[str, ...] = ()        # finish phase statements
    stores: Tuple[str, ...] = ()
    sums: Tuple[Tuple[str, Optional[str]], ...] = ()
    argmaxes: Tuple[str, ...] = ()


def gemv_blocks(cfg) -> Tuple[int, int, int]:
    """(BO, BR, warps) of the gemv anchor's kernel under a tile config:
    block_m and block_n, powers of two, else BLOCKS["gemv"]. Raises
    ValueError for a tile over MAX_TILE float32 accumulators, which live
    in registers (64 a thread at 4 warps)."""
    bo, br, warps = BLOCKS["gemv"]
    if cfg is not None:
        bo = cfg.block_m or bo
        br = cfg.block_n or br
    for v in (bo, br):
        if v & (v - 1) or not 1 <= v <= 4096:
            raise ValueError(f"gemv anchor block {v}: a power of two in "
                             f"[1, 4096]")
    if bo * br > MAX_TILE:
        raise ValueError(f"gemv anchor tile ({bo}, {br}): more than "
                         f"{MAX_TILE} accumulators")
    return bo, br, warps


def footprint(body: "AnchoredBody", itemsize: int,
              cfg=None) -> Tuple[common.Footprint, ...]:
    """Shared memory per block of an anchored group's kernels under
    `cfg`. The gemv anchor (an estimate: Triton allocates it): the
    staging of the row sums' layout change, at most 4 float32 per row
    and warp, and the reductions' cross-warp steps (one float32 per
    thread each); its loads are not staged through shared memory
    (chip_smoke.py reads each compiled variant's request: 128-1024
    bytes). Then the combine (`window.finish_footprint`). A symv or
    gemvt anchor: its product's CUDA kernels, then the epilogue's walk.
    `itemsize` is the matrix's."""
    if body.anchor == "symv":
        return symv.footprint(itemsize, cfg) + window.footprint(
            epilogue_body(body))
    if body.anchor == "gemvt":
        return gemv.gemvt_footprint(itemsize, cfg) + window.footprint(
            epilogue_body(body))
    bo, _, warps = gemv_blocks(cfg)
    per = len(body.sums) + 2 * len(body.argmaxes)
    return (common.Footprint("anchored_kernel",
                             4 * 4 * bo * warps + 4 * 32 * warps * per),
            ) + window.finish_footprint(body)


def product_route(anchor: str, a: torch.Tensor) -> Optional[str]:
    """The counted route of an anchor's product on matrix `a`
    ("symv/tma", "gemvt/ldg", ...), or None for the gemv anchor, which
    launches no product. Shapes, dtypes and addresses only: it also
    answers for CPU tensors."""
    if anchor == "symv":
        return f"symv/{symv.symv_route(a)}"
    if anchor == "gemvt":
        return f"gemvt/{gemv.gemvt_route(a)}"
    return None


@functools.lru_cache(maxsize=None)
def epilogue_body(body: AnchoredBody) -> window.WindowBody:
    """The window pass that finishes a symv or gemvt anchor's product:
    inputs x0 .. x{k-1} are the output-aligned vectors and x{k} the raw
    float32 product."""
    acc = f"x{body.n_inputs}"
    yo = f"yo = {body.alpha} * {acc} + {body.beta} * {body.rows}"
    return window.WindowBody(
        n_scalars=body.n_scalars, n_inputs=body.n_inputs + 1,
        lines=body.pre + (yo,) + body.post, stores=body.stores,
        sums=body.sums, argmaxes=body.argmaxes)


# the gemv anchor's matrix walk: A's rows against x, reduced along axis 1
_WALK = [
    "        a = tl.load(a_ptr + rows64[:, None] * lda + red[None, :],"
    " mask=mask[:, None] & rmask[None, :], other=0.0)"
    ".to(tl.float32)",
    "        acc2 += a * xc[None, :]",
]


def source(body: AnchoredBody) -> str:
    """The Triton module for one anchored group: for the gemv anchor
    `anchored_kernel` (and `finish_kernel` when the body reduces), for
    the symv and gemvt anchors the epilogue's `window_kernel`."""
    if body.anchor in PRODUCTS:
        return window.source(epilogue_body(body))
    ns, ni = body.n_scalars, body.n_inputs
    params = (["scal_ptr"] if ns else []) + ["a_ptr", "xc_ptr"] \
        + [f"x{i}_ptr" for i in range(ni)] + window.output_params(body)
    out = window.HEADER + [
        "@triton.jit",
        f"def anchored_kernel({', '.join(params)}, n_out, n_red, lda, P, "
        "BO: tl.constexpr, BR: tl.constexpr):",
        "    pid = tl.program_id(0)",
        "    offs = pid * BO + tl.arange(0, BO)",
        "    mask = offs < n_out",
        "    rows64 = offs.to(tl.int64)",
    ]
    out += [f"    s{i} = tl.load(scal_ptr + {i})" for i in range(ns)]
    out += [f"    x{i} = tl.load(x{i}_ptr + offs, mask=mask, other=0.0)"
            f".to(tl.float32)" for i in range(ni)]
    out += [f"    {line}" for line in body.pre]
    out += [
        "    acc2 = tl.zeros([BO, BR], dtype=tl.float32)",
        "    for start in range(0, n_red, BR):",
        "        red = start + tl.arange(0, BR)",
        "        rmask = red < n_red",
        "        xc = tl.load(xc_ptr + red, mask=rmask, other=0.0)"
        ".to(tl.float32)",
    ] + _WALK + [
        f"    yo = {body.alpha} * tl.sum(acc2, axis=1) "
        f"+ {body.beta} * {body.rows}",
    ]
    out += [f"    {line}" for line in body.post]
    out += window.epilogue_source(body, "BO")
    out += window.finish_source(body)
    return "\n".join(out) + "\n"


_MODULES: dict = {}


def load(body: AnchoredBody):
    """The imported Triton module of the gemv anchor's `body`, built
    once per process."""
    mod = _MODULES.get(body)
    if mod is None:
        mod = common.load_source(f"anchored_{body.anchor}", source(body))
        _MODULES[body] = mod
    return mod


def launch(body: AnchoredBody, scalars: Sequence, a: torch.Tensor,
           xc: torch.Tensor, inputs: Sequence[torch.Tensor],
           out_dtype: torch.dtype, tiles=None):
    """Run one anchored group on the card. `scalars` are the body's
    scalar operands (numbers or 0-d tensors), `a` the anchor's matrix,
    `xc` its reduction-axis vector, `inputs` the output-aligned vectors
    in body order, `tiles` the group's tile config or None.

    Returns (element-wise outputs, (len(sums),) float32 results or None,
    (len(argmaxes),) int32 indices or None, number of fold and finish
    launches, 1 where the epilogue's last program combined the
    partials (else 0), the product's route or None)."""
    for v in (xc, *inputs):
        if not v.is_contiguous():
            raise ValueError("anchored kernels take contiguous vectors")
    dtypes = [out_dtype] * len(body.stores)
    if body.anchor in PRODUCTS:
        make = symv.product if body.anchor == "symv" else gemv.gemvt_product
        acc, route = make(a, xc, tiles)
        outs, sums, idxs, folded = window.launch(
            f"anchored_{body.anchor}", epilogue_body(body), scalars,
            [*inputs, acc], dtypes)
        folds = int(body.anchor == "symv")   # symv's fold of its slots
        return outs, sums, idxs, folds, folded, f"{body.anchor}/{route}"
    mod = load(body)
    m, n = a.shape
    bo, br, warps = gemv_blocks(tiles)
    p = common.cdiv(m, bo)
    dev = a.device
    outs = [torch.empty(m, dtype=dt, device=dev) for dt in dtypes]
    partials, finals, sums, idxs = window.reduction_buffers(body, p, dev)
    args = ([common.scalar_block(scalars, dev)] if body.n_scalars else []) \
        + [a, xc, *inputs, *outs]
    mod.anchored_kernel[(p,)](*args, *partials, m, n, n, p,
                              BO=bo, BR=br, num_warps=warps,
                              num_stages=NUM_STAGES)
    return outs, sums, idxs, window.finish(mod, body, finals, p), 0, None
