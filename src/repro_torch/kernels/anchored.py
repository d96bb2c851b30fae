"""The anchored-group generator: one Triton kernel for a gemv, gemvt or
symv anchor together with the level-1 routines fused around it.

Replaces the Pallas kernel that `repro/core/codegen.py::
_build_anchored_kernel` (:463-592) builds and `make_anchored_callable`
launches (its `pallas_call` at codegen.py:655). `core/codegen.py`
splices the member routines' `tl` templates (the same ones the level-1
generator and the standalone kernels use) into an `AnchoredBody`;
`source` renders it as a Triton module and `launch` runs it.

One program owns one block of BO output elements: rows of A for gemv
and symv, columns of A for gemvt. On the TPU the grid's reduction axis
ran in order and carried the accumulator in VMEM scratch from step to
step; here a loop inside the program takes its place:

* row phase — load the output-aligned vectors once, run the `pre`
  members (producers of the anchor's y);
* matrix walk — stream A in (BO, BR) tiles against the reduction-axis
  vector, accumulating float32 products element-wise in registers and
  summing them once after the loop. `tl.dot` is not used: it needs
  dimensions of at least 16 and runs float32 in TF32, and a matvec is
  bound by bytes anyway. symv selects per element between the stored
  lower-triangle element and its mirror, loading only the side of the
  diagonal it uses (masked loads), so the upper triangle is never read;
* finish phase — y' = alpha acc + beta y, the `post` members on the
  finished block, the element-wise stores, and one partial per
  reduction per program, which `finish_kernel` (window.py) combines in
  a fixed order. The ragged edge is masked and kept out of every
  reduction (the reference pads it, ROADMAP Queue 3).

Bound on an H100 SXM: HBM bytes, the matrix read once plus the group's
vectors (CG_MATVEC at n = 16384 float32: 4(n² + 2n) bytes, 0.32 ms).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import common, window

# anchor -> (BO output elements per program, BR reduction elements per
# loop step, warps)
BLOCKS = {"gemv": (32, 128, 4), "symv": (32, 128, 4), "gemvt": (128, 32, 4)}
NUM_STAGES = 3


@dataclasses.dataclass(frozen=True)
class AnchoredBody:
    """What one anchored kernel computes.

    Names inside the statements: `s0, s1, ...` are the float32 scalars,
    `x0, x1, ...` the output-aligned input blocks widened to float32,
    `xc` the reduction-axis vector (inside the matrix walk only), `yo`
    the anchor's finished output block, and `offs` the global output
    indices of the block."""
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


def _walk(anchor: str):
    """The matrix walk of one anchor kind: (tile load lines, the
    product's reduction axis)."""
    if anchor == "gemvt":
        # output over A's columns, reduction down its rows
        return [
            "        a = tl.load(a_ptr + red.to(tl.int64)[:, None] * lda"
            " + offs[None, :], mask=rmask[:, None] & mask[None, :],"
            " other=0.0).to(tl.float32)",
            "        acc2 += a * xc[:, None]",
        ], 0
    if anchor == "symv":
        # the stored element where row >= column, else its mirror; each
        # load is masked to its side of the diagonal
        return [
            "        inb = mask[:, None] & rmask[None, :]",
            "        low = offs[:, None] >= red[None, :]",
            "        a_lo = tl.load(a_ptr + rows64[:, None] * lda"
            " + red[None, :], mask=inb & low, other=0.0)",
            "        a_up = tl.load(a_ptr + red.to(tl.int64)[None, :] * lda"
            " + offs[:, None], mask=inb & (offs[:, None] < red[None, :]),"
            " other=0.0)",
            "        a = tl.where(low, a_lo, a_up).to(tl.float32)",
            "        acc2 += a * xc[None, :]",
        ], 1
    return [
        "        a = tl.load(a_ptr + rows64[:, None] * lda + red[None, :],"
        " mask=mask[:, None] & rmask[None, :], other=0.0)"
        ".to(tl.float32)",
        "        acc2 += a * xc[None, :]",
    ], 1


def source(body: AnchoredBody) -> str:
    """The Triton module (`anchored_kernel`, and `finish_kernel` when
    the body reduces) for one anchored group."""
    ns, ni = body.n_scalars, body.n_inputs
    params = (["scal_ptr"] if ns else []) + ["a_ptr", "xc_ptr"] \
        + [f"x{i}_ptr" for i in range(ni)] + window.output_params(body)
    walk, axis = _walk(body.anchor)
    shape = "[BR, BO]" if axis == 0 else "[BO, BR]"
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
        f"    acc2 = tl.zeros({shape}, dtype=tl.float32)",
        "    for start in range(0, n_red, BR):",
        "        red = start + tl.arange(0, BR)",
        "        rmask = red < n_red",
        "        xc = tl.load(xc_ptr + red, mask=rmask, other=0.0)"
        ".to(tl.float32)",
    ] + walk + [
        f"    yo = {body.alpha} * tl.sum(acc2, axis={axis}) "
        f"+ {body.beta} * {body.rows}",
    ]
    out += [f"    {line}" for line in body.post]
    out += window.epilogue_source(body, "BO")
    out += window.finish_source(body)
    return "\n".join(out) + "\n"


_MODULES: dict = {}


def load(body: AnchoredBody):
    """The imported Triton module for `body`, built once per process."""
    mod = _MODULES.get(body)
    if mod is None:
        mod = common.load_source(f"anchored_{body.anchor}", source(body))
        _MODULES[body] = mod
    return mod


def launch(body: AnchoredBody, scalars: torch.Tensor, a: torch.Tensor,
           xc: torch.Tensor, inputs: Sequence[torch.Tensor],
           out_dtype: torch.dtype):
    """Run one anchored group on the card. `a` is the anchor's matrix,
    `xc` its reduction-axis vector, `inputs` the output-aligned vectors
    in body order.

    Returns (element-wise outputs, (len(sums),) float32 results or None,
    (len(argmaxes),) int32 indices or None, number of finish launches).
    """
    for v in (xc, *inputs):
        if not v.is_contiguous():
            raise ValueError("anchored kernels take contiguous vectors")
    mod = load(body)
    m, n = a.shape
    n_out, n_red = (n, m) if body.anchor == "gemvt" else (m, n)
    bo, br, warps = BLOCKS[body.anchor]
    p = common.cdiv(n_out, bo)
    dev = a.device
    outs = [torch.empty(n_out, dtype=out_dtype, device=dev)
            for _ in body.stores]
    partials, finals, sums, idxs = window.reduction_buffers(body, p, dev)
    args = ([scalars] if body.n_scalars else []) + [a, xc, *inputs, *outs]
    mod.anchored_kernel[(p,)](*args, *partials, n_out, n_red, n, p,
                              BO=bo, BR=br, num_warps=warps,
                              num_stages=NUM_STAGES)
    return outs, sums, idxs, window.finish(mod, body, finals, p)
