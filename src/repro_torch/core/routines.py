"""Routine registry — the library's catalogue of BLAS routines.

Mirrors the paper's §III: each routine has a signature (scalar 'stream'
args + vector/matrix 'window' args), a BLAS level, an element-wise /
reduction classification that drives the fusion planner, a FLOP/byte
cost model, a torch oracle, its Hopper kernel where one is ported, and —
for fusable level-1 routines — two emitters: a torch function (the
plain version of a generated group, run on CPU tensors) and a `tl`
expression template that the group generator splices into a generated
Triton kernel. The templates are the ones the standalone kernels use
(`kernels/axpy.py::TL_EXPR`, `kernels/dot.py::TL_TERM`).

Every routine with a Pallas kernel in the reference has its Hopper
kernel here (`kernel`). Routines with no kernel in the reference
(`coldot`, `colaxpy`, `vdiv`, `amax`) run their oracle in every mode,
as in the reference (`codegen.py:106-109`);
`coldot` and `colaxpy` also carry the templates that the gemm-anchored
tile generator splices (kernels/tiled.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import axpy as axpy_mod, dot as dot_mod, ops, ref

# port roles
VEC = "vector"
MAT = "matrix"
OUT_VEC = "out_vector"
OUT_MAT = "out_matrix"
OUT_SCALAR = "out_scalar"


@dataclasses.dataclass(frozen=True)
class RoutineDef:
    """Static description of one BLAS routine."""
    name: str
    level: int
    scalars: tuple  # scalar ('stream') parameter names, in order
    inputs: Mapping[str, str]   # port name -> VEC | MAT
    outputs: Mapping[str, str]  # port name -> OUT_*
    # classification for the fusion planner
    eltwise: bool = False       # pointwise producer (axpy/scal/waxpby)
    reduction: bool = False     # vector -> scalar sink (dot/asum/nrm2)
    # index-carrying reduction (iamax): the generated kernel tracks a
    # (block max, first index) pair instead of a sum
    index_reduction: bool = False
    # streaming anchor (gemv/symv/gemvt/gemm): the routine can anchor a
    # mixed-level fusion group whose fusable neighbours consume (or
    # produce) its blocked output on-chip. `anchor_ports` names the
    # roles the anchored-kernel generator tiles against:
    #   mat  — the streamed matrix operand
    #   cols — the reduction-axis operand: the column-aligned vector
    #          for gemv/symv, x for gemvt (length m), B for gemm
    #   rows — the output-aligned accumulator operand: y for
    #          gemv/symv/gemvt, C for gemm
    anchor: bool = False
    anchor_ports: Optional[Mapping[str, str]] = None
    # codegen hooks
    emitter: Optional[Callable] = None      # torch f32 expression
    # `tl` templates over the scalar and input port names: one per
    # output for element-wise routines, the per-element term for sums
    tl_template: Optional[Union[str, Tuple[str, ...]]] = None
    post: Optional[Callable] = None         # applied after full reduction
    tl_post: Optional[str] = None           # the same, in the kernel
    kernel: Optional[Callable] = None       # standalone Hopper kernel
    reference: Optional[Callable] = None    # torch oracle
    # cost model: fn(shapes: dict port->shape) -> (flops, bytes)
    cost: Optional[Callable] = None

    @property
    def fusable(self) -> bool:
        return self.eltwise or self.reduction


def _vbytes(*shapes, dtype_bytes=4):
    n = 0
    for s in shapes:
        t = 1
        for d in s:
            t *= d
        n += t
    return n * dtype_bytes


_REGISTRY: dict[str, RoutineDef] = {}


def register(rdef: RoutineDef) -> RoutineDef:
    if rdef.name in _REGISTRY:
        raise ValueError(f"duplicate routine {rdef.name!r}")
    _REGISTRY[rdef.name] = rdef
    return rdef


def get(name: str) -> RoutineDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown BLAS routine {name!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def names() -> Sequence[str]:
    return sorted(_REGISTRY)


def _eltwise_tl(name):
    return axpy_mod.TL_EXPR[name][2]


def _term_tl(name):
    return dot_mod.TL_TERM[name][1]


# ---------------------------------------------------------------------------
# Level 1 — element-wise producers
# ---------------------------------------------------------------------------

register(RoutineDef(
    name="axpy", level=1, scalars=("alpha",),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: s["alpha"] * x + y,
    tl_template=_eltwise_tl("axpy"),
    kernel=ops.axpy,
    reference=lambda s, x, y: ref.axpy(s["alpha"], x, y),
    cost=lambda sh: (2 * sh["x"][0], _vbytes(sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="scal", level=1, scalars=("alpha",),
    inputs={"x": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x: s["alpha"] * x,
    tl_template=_eltwise_tl("scal"),
    kernel=ops.scal,
    reference=lambda s, x: ref.scal(s["alpha"], x),
    cost=lambda sh: (sh["x"][0], _vbytes(sh["x"], sh["x"])),
))

register(RoutineDef(
    name="waxpby", level=1, scalars=("alpha", "beta"),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: s["alpha"] * x + s["beta"] * y,
    tl_template=_eltwise_tl("waxpby"),
    kernel=ops.waxpby,
    reference=lambda s, x, y: ref.waxpby(s["alpha"], x, s["beta"], y),
    cost=lambda sh: (3 * sh["x"][0], _vbytes(sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="vsub", level=1, scalars=(),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: x - y,
    tl_template=("{x} - {y}",),
    kernel=lambda x, y: ops.axpy(-1.0, y, x),
    reference=lambda s, x, y: x - y,
    cost=lambda sh: (sh["x"][0], _vbytes(sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="vmul", level=1, scalars=(),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: x * y,
    tl_template=_eltwise_tl("vmul"),
    kernel=ops.vmul,
    reference=lambda s, x, y: x * y,
    cost=lambda sh: (sh["x"][0], _vbytes(sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="copy", level=1, scalars=(),
    inputs={"x": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x: x,
    tl_template=_eltwise_tl("copy"),
    kernel=ops.copy,
    reference=lambda s, x: ref.copy(x),
    cost=lambda sh: (0, _vbytes(sh["x"], sh["x"])),
))

register(RoutineDef(
    name="rot", level=1, scalars=("c", "s"),
    inputs={"x": VEC, "y": VEC},
    outputs={"out_x": OUT_VEC, "out_y": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: (s["c"] * x + s["s"] * y,
                             s["c"] * y - s["s"] * x),
    tl_template=_eltwise_tl("rot"),
    kernel=ops.rot,
    reference=lambda s, x, y: ref.rot(s["c"], s["s"], x, y),
    cost=lambda sh: (6 * sh["x"][0],
                     _vbytes(sh["x"], sh["y"], sh["x"], sh["y"])),
))

# ---------------------------------------------------------------------------
# Level 1 — reductions
# ---------------------------------------------------------------------------

register(RoutineDef(
    name="dot", level=1, scalars=(),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_SCALAR},
    reduction=True,
    emitter=lambda s, x, y: torch.sum(x * y),
    tl_template=_term_tl("dot"),
    kernel=ops.dot,
    reference=lambda s, x, y: ref.dot(x, y),
    cost=lambda sh: (2 * sh["x"][0], _vbytes(sh["x"], sh["y"])),
))

register(RoutineDef(
    name="asum", level=1, scalars=(),
    inputs={"x": VEC}, outputs={"out": OUT_SCALAR},
    reduction=True,
    emitter=lambda s, x: torch.sum(torch.abs(x)),
    tl_template=_term_tl("asum"),
    kernel=ops.asum,
    reference=lambda s, x: ref.asum(x),
    cost=lambda sh: (sh["x"][0], _vbytes(sh["x"])),
))

register(RoutineDef(
    name="nrm2", level=1, scalars=(),
    inputs={"x": VEC}, outputs={"out": OUT_SCALAR},
    reduction=True,
    emitter=lambda s, x: torch.sum(x * x),
    tl_template=_term_tl("nrm2"),
    post=torch.sqrt,
    tl_post=dot_mod.TL_TERM["nrm2"][2],
    kernel=ops.nrm2,
    reference=lambda s, x: ref.nrm2(x),
    cost=lambda sh: (2 * sh["x"][0], _vbytes(sh["x"])),
))

register(RoutineDef(
    name="iamax", level=1, scalars=(),
    inputs={"x": VEC}, outputs={"out": OUT_SCALAR},
    reduction=True, index_reduction=True,
    # the kernel generator synthesizes the (block max, first index)
    # pair itself (kernels/window.py); the torch emitter is the plain
    # version's whole-vector argmax
    emitter=lambda s, x: ref.iamax(x),
    kernel=ops.iamax,
    reference=lambda s, x: ref.iamax(x),
    cost=lambda sh: (2 * sh["x"][0], _vbytes(sh["x"])),
))

# ---------------------------------------------------------------------------
# Level 2 / 3 — standalone kernels (their own fusion groups, or anchors
# of one).
# ---------------------------------------------------------------------------

register(RoutineDef(
    name="gemv", level=2, scalars=("alpha", "beta"),
    inputs={"A": MAT, "x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    anchor=True,
    anchor_ports={"mat": "A", "cols": "x", "rows": "y"},
    reference=lambda s, A, x, y: ref.gemv(s["alpha"], A, x, s["beta"], y),
    kernel=ops.gemv,
    cost=lambda sh: (2 * sh["A"][0] * sh["A"][1],
                     _vbytes(sh["A"], sh["x"], sh["y"], (sh["A"][0],))),
))

register(RoutineDef(
    name="symv", level=2, scalars=("alpha", "beta"),
    inputs={"A": MAT, "x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    anchor=True,
    anchor_ports={"mat": "A", "cols": "x", "rows": "y"},
    reference=lambda s, A, x, y: ref.symv(s["alpha"], A, x, s["beta"], y),
    kernel=ops.symv,
    # only the lower triangle of A is read: ~n²/2 matrix bytes
    cost=lambda sh: (2 * sh["A"][0] * sh["A"][0],
                     _vbytes(sh["x"], sh["y"], (sh["A"][0],))
                     + 2 * sh["A"][0] * sh["A"][0]),
))

register(RoutineDef(
    name="gemvt", level=2, scalars=("alpha", "beta"),
    inputs={"A": MAT, "x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    # anchored tier: output tiles over A's columns, reduction over A's
    # row blocks — x is the reduction-axis ("cols") operand (length m)
    # and y the output-aligned ("rows") accumulator (length n)
    anchor=True,
    anchor_ports={"mat": "A", "cols": "x", "rows": "y"},
    reference=lambda s, A, x, y: ref.gemvt(s["alpha"], A, x,
                                           s["beta"], y),
    kernel=ops.gemvt,
    cost=lambda sh: (2 * sh["A"][0] * sh["A"][1],
                     _vbytes(sh["A"], sh["x"], sh["y"],
                             (sh["A"][1],))),
))

register(RoutineDef(
    name="transpose", level=2, scalars=(),
    inputs={"A": MAT}, outputs={"out": OUT_MAT},
    reference=lambda s, A: ref.transpose(A),
    kernel=ops.transpose,
    cost=lambda sh: (0, 2 * 4 * sh["A"][0] * sh["A"][1]),
))

register(RoutineDef(
    name="ger", level=2, scalars=("alpha",),
    inputs={"x": VEC, "y": VEC, "A": MAT}, outputs={"out": OUT_MAT},
    reference=lambda s, x, y, A: ref.ger(s["alpha"], x, y, A),
    kernel=ops.ger,
    cost=lambda sh: (2 * sh["A"][0] * sh["A"][1],
                     _vbytes(sh["A"], sh["A"], sh["x"], sh["y"])),
))

register(RoutineDef(
    name="gemm", level=3, scalars=("alpha", "beta"),
    inputs={"A": MAT, "B": MAT, "C": MAT}, outputs={"out": OUT_MAT},
    # level-3 anchor: 2-D (bm, bn) output tiles with a (bk,) contraction
    # walk — B is the reduction-axis ("cols") operand and C the
    # output-tile-aligned ("rows") accumulator
    anchor=True,
    anchor_ports={"mat": "A", "cols": "B", "rows": "C"},
    reference=lambda s, A, B, C: ref.gemm(s["alpha"], A, B, s["beta"], C),
    kernel=ops.gemm,
    cost=lambda sh: (2 * sh["A"][0] * sh["A"][1] * sh["B"][1],
                     _vbytes(sh["A"], sh["B"], sh["C"], sh["C"])),
))

# ---------------------------------------------------------------------------
# Level 1 — columnwise (panel) routines for blocked multi-RHS algorithms.
# These act on (n, s) panels: s independent length-n vectors sharing one
# stream. They have no standalone kernel (the torch oracle runs in every
# mode); a gemm-anchored tile group splices their templates against its
# (bm, bn) tile (kernels/tiled.py).
# ---------------------------------------------------------------------------

register(RoutineDef(
    name="coldot", level=1, scalars=(),
    inputs={"x": MAT, "y": MAT}, outputs={"out": OUT_VEC},
    reduction=True,
    # tile layout: the per-element term of a (bm, bn) tile, summed down
    # its rows into a (1, bn) partial that the tile generator folds
    # across row tiles; the torch emitter is the plain splice's
    emitter=lambda s, x, y: torch.sum(x * y, dim=0),
    tl_template="{x} * {y}",
    reference=lambda s, x, y: torch.sum(x * y, dim=0),
    cost=lambda sh: (2 * sh["x"][0] * sh["x"][1],
                     _vbytes(sh["x"], sh["y"], (sh["x"][1],))),
))

register(RoutineDef(
    name="colaxpy", level=1, scalars=(),
    inputs={"a": VEC, "x": MAT, "y": MAT}, outputs={"out": OUT_MAT},
    eltwise=True,
    # a broadcasts along the trailing (column) axis in both layouts:
    # (s,)·(n, s) here, (1, bn)·(bm, bn) in a tile group
    emitter=lambda s, a, x, y: a * x + y,
    tl_template=("{a} * {x} + {y}",),
    reference=lambda s, a, x, y: a * x + y,
    cost=lambda sh: (2 * sh["x"][0] * sh["x"][1],
                     _vbytes(sh["a"], sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="vdiv", level=1, scalars=(),
    inputs={"x": VEC, "y": VEC}, outputs={"out": OUT_VEC},
    eltwise=True,
    emitter=lambda s, x, y: x / y,
    tl_template=("{x} / {y}",),
    reference=lambda s, x, y: x / y,
    cost=lambda sh: (sh["x"][0], _vbytes(sh["x"], sh["y"], sh["x"])),
))

register(RoutineDef(
    name="amax", level=1, scalars=(),
    inputs={"x": VEC}, outputs={"out": OUT_SCALAR},
    # deliberately NOT marked `reduction`: the fused-kernel generator's
    # cross-block combine is additive, which would mis-combine a max —
    # amax always runs standalone (torch oracle in every mode)
    reference=lambda s, x: torch.max(torch.abs(x)),
    cost=lambda sh: (2 * sh["x"][0], _vbytes(sh["x"])),
))
