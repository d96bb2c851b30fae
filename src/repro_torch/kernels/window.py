"""The window walk: one Triton pass over 1-D vectors, shared by the
standalone level-1 kernels (axpy.py, dot.py, axpydot.py) and the
fused-group generator (core/codegen.py).

It takes the place of the reference's (block_rows, 128) window walk
(`repro/kernels/axpy.py::_eltwise_call`, `repro/kernels/dot.py::
_reduce_call`, `repro/kernels/axpydot.py::axpydot` and the generated
`repro/core/codegen.py::make_group_callable`). A `WindowBody` names
what one pass computes; `source` renders it as a Triton module with two
kernels, and `launch` runs them:

* `window_kernel` — one program per BLOCK consecutive elements. The
  ragged tail is masked, not padded. Inputs are loaded and widened to
  float32, the body's statements run in registers, element-wise results
  are rounded to their output buffer's dtype on store. A reduction
  writes one float32 partial per block (for an index reduction, the
  block's max |x| and the first index that reaches it).
* `finish_kernel` — one program that combines the partials in a fixed
  order. On the TPU the grid runs in order and a kernel carries its sum
  from step to step; blocks on a GPU run in parallel and in no order, so
  the combine is a second, tiny launch instead. It uses no atomics, so a
  result is bitwise the same from run to run.

Bound: every body here moves at most a few bytes per flop, far below
the H100's ridge, so a pass is bound by HBM bytes (3.35 TB/s). The
design answers with one read of each input and one write of each
output, 16-byte vector loads (8 warps over 4096 elements: 16 float32
values a thread), and no shared memory or padding copies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import common

BLOCK = 4096          # elements per program of the main kernel
NUM_WARPS = 8
FINISH_BLOCK = 1024   # partials per step of the combine


@dataclasses.dataclass(frozen=True)
class WindowBody:
    """What one window pass computes.

    Names inside the statements: `s0, s1, ...` are the float32 scalars,
    `x0, x1, ...` the input blocks widened to float32, and `offs` the
    global element indices of the block."""
    n_scalars: int
    n_inputs: int
    lines: Tuple[str, ...] = ()       # `name = expression` statements
    stores: Tuple[str, ...] = ()      # one element-wise output each
    # (per-element term, post function such as "tl.sqrt" or None)
    sums: Tuple[Tuple[str, Optional[str]], ...] = ()
    argmaxes: Tuple[str, ...] = ()    # first index of max |value|


HEADER = ["import triton", "import triton.language as tl", "", ""]


def source(body: WindowBody) -> str:
    """The Triton module for one window pass."""
    ns, ni = body.n_scalars, body.n_inputs
    params = (["scal_ptr"] if ns else []) \
        + [f"x{i}_ptr" for i in range(ni)] + output_params(body)
    out = HEADER + [
        "@triton.jit",
        f"def window_kernel({', '.join(params + ['n', 'P', 'BLOCK: tl.constexpr'])}):",
        "    pid = tl.program_id(0)",
        "    offs = pid * BLOCK + tl.arange(0, BLOCK)",
        "    mask = offs < n",
    ]
    out += [f"    s{i} = tl.load(scal_ptr + {i})" for i in range(ns)]
    out += [f"    x{i} = tl.load(x{i}_ptr + offs, mask=mask, other=0.0)"
            f".to(tl.float32)" for i in range(ni)]
    out += [f"    {line}" for line in body.lines]
    out += epilogue_source(body)
    out += finish_source(body)
    return "\n".join(out) + "\n"


def output_params(body) -> List[str]:
    """Kernel parameters of a body's outputs: one buffer per element-wise
    store, then the per-block partials of its reductions."""
    return [f"o{i}_ptr" for i in range(len(body.stores))] \
        + (["psum_ptr"] if body.sums else []) \
        + (["pmax_ptr", "pidx_ptr"] if body.argmaxes else [])


def epilogue_source(body) -> List[str]:
    """The end of a main kernel: store each element-wise output, and
    write one partial per reduction for this program. Expects `pid`,
    `offs` (global element indices), `mask` and `P` (programs) in scope;
    shared by the window walk and the anchored generator (anchored.py),
    whose bodies carry the same `stores`, `sums` and `argmaxes`."""
    out = []
    for i, expr in enumerate(body.stores):
        out.append(f"    tl.store(o{i}_ptr + offs, ({expr})"
                   f".to(o{i}_ptr.dtype.element_ty), mask=mask)")
    for r, (term, _) in enumerate(body.sums):
        out.append(f"    tl.store(psum_ptr + {r} * P + pid, "
                   f"tl.sum(tl.where(mask, {term}, 0.0), axis=0))")
    for a, val in enumerate(body.argmaxes):
        # masked lanes read -1, below every |x|; ties keep the first
        # index inside the block through the min over matching lanes
        out += [
            f"    a{a} = tl.where(mask, tl.abs({val}), -1.0)",
            f"    m{a} = tl.max(a{a}, axis=0)",
            f"    tl.store(pmax_ptr + {a} * P + pid, m{a})",
            f"    tl.store(pidx_ptr + {a} * P + pid, tl.min(tl.where("
            f"a{a} == m{a}, offs, {common.INT32_MAX}), axis=0))",
        ]
    return out


def finish_source(body) -> List[str]:
    """The fixed-order combine of a body's reduction partials
    (`finish_kernel`), or nothing when the body has no reduction."""
    nr, na = len(body.sums), len(body.argmaxes)
    if not (nr or na):
        return []
    params = (["psum_ptr", "osum_ptr"] if nr else []) \
        + (["pmax_ptr", "pidx_ptr", "oidx_ptr"] if na else [])
    out = [
        "",
        "",
        "@triton.jit",
        f"def finish_kernel({', '.join(params + ['P', 'FBLOCK: tl.constexpr'])}):",
        "    lanes = tl.arange(0, FBLOCK)",
    ]
    for r, (_, post) in enumerate(body.sums):
        total = f"tl.sum(acc{r}, axis=0)"
        out += [
            f"    acc{r} = tl.zeros([FBLOCK], dtype=tl.float32)",
            "    for start in range(0, P, FBLOCK):",
            "        o = start + lanes",
            f"        acc{r} += tl.load(psum_ptr + {r} * P + o, "
            f"mask=o < P, other=0.0)",
            f"    tl.store(osum_ptr + {r}, "
            f"{f'{post}({total})' if post else total})",
        ]
    for a in range(na):
        # lane j walks partials j, j + FBLOCK, ... in block order; the
        # strict compare keeps each lane's earliest block, and the final
        # min over tied lanes keeps the first index overall
        out += [
            f"    best{a} = tl.full([FBLOCK], -1.0, tl.float32)",
            f"    bidx{a} = tl.zeros([FBLOCK], dtype=tl.int32)",
            "    for start in range(0, P, FBLOCK):",
            "        o = start + lanes",
            f"        m = tl.load(pmax_ptr + {a} * P + o, mask=o < P, "
            f"other=-2.0)",
            f"        i = tl.load(pidx_ptr + {a} * P + o, mask=o < P, "
            f"other=0)",
            f"        better = m > best{a}",
            f"        bidx{a} = tl.where(better, i, bidx{a})",
            f"        best{a} = tl.where(better, m, best{a})",
            f"    top{a} = tl.max(best{a}, axis=0)",
            f"    tl.store(oidx_ptr + {a}, tl.min(tl.where(best{a} == "
            f"top{a}, bidx{a}, {common.INT32_MAX}), axis=0))",
        ]
    return out


def reduction_buffers(body, p: int, dev: torch.device):
    """Scratch and results of a body's reductions over `p` programs:
    (partials for the main kernel, arguments of finish_kernel,
    (len(sums),) float32 results or None, (len(argmaxes),) int32
    indices or None)."""
    nr, na = len(body.sums), len(body.argmaxes)
    partials, finals, sums, idxs = [], [], None, None
    if nr:
        psum = torch.empty((nr, p), dtype=torch.float32, device=dev)
        sums = torch.empty(nr, dtype=torch.float32, device=dev)
        partials.append(psum)
        finals += [psum, sums]
    if na:
        pmax = torch.empty((na, p), dtype=torch.float32, device=dev)
        pidx = torch.empty((na, p), dtype=torch.int32, device=dev)
        idxs = torch.empty(na, dtype=torch.int32, device=dev)
        partials += [pmax, pidx]
        finals += [pmax, pidx, idxs]
    return partials, finals, sums, idxs


def finish(mod, body, finals, p: int) -> int:
    """Launch the combine of a body's partials; returns the number of
    launches (0 or 1)."""
    if not (body.sums or body.argmaxes):
        return 0
    mod.finish_kernel[(1,)](*finals, p, FBLOCK=FINISH_BLOCK, num_warps=4)
    return 1


_MODULES: dict = {}


def load(stem: str, body: WindowBody):
    """The imported Triton module for `body`, built and imported once
    per process."""
    mod = _MODULES.get(body)
    if mod is None:
        mod = common.load_source(stem, source(body))
        _MODULES[body] = mod
    return mod


def launch(stem: str, body: WindowBody, scalars: Optional[torch.Tensor],
           inputs: Sequence[torch.Tensor],
           out_dtypes: Sequence[torch.dtype]):
    """Run one window pass on the card.

    Returns (element-wise outputs, (len(sums),) float32 results or None,
    (len(argmaxes),) int32 indices or None, number of finish launches).
    """
    for v in inputs:
        if not v.is_contiguous():
            raise ValueError("window kernels take contiguous vectors")
    mod = load(stem, body)
    n = inputs[0].shape[0]
    dev = inputs[0].device
    p = common.cdiv(n, BLOCK)
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
    partials, finals, sums, idxs = reduction_buffers(body, p, dev)
    args = ([scalars] if body.n_scalars else []) + list(inputs) + outs
    mod.window_kernel[(p,)](*args, *partials, n, p, BLOCK=BLOCK,
                            num_warps=NUM_WARPS)
    return outs, sums, idxs, finish(mod, body, finals, p)
