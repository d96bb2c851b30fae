"""Public entry points for the port's level-1 kernels.

Each op launches its Triton kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; `ref.py` holds the oracles with the
reference's semantics. `axpydot_nodf` is the deliberately non-dataflow
axpydot (two kernels, z round-trips through HBM): the paper's "w/o DF"
bar.

`gesummv`, `atax` and `bicgk` compose the level-2 kernels, which come
with slice 2 (ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

from . import ref  # noqa: F401  (re-exported for convenience)
from .axpy import axpy, copy, rot, scal, vmul, waxpby
from .axpydot import axpydot
from .dot import asum, dot, iamax, nrm2

__all__ = [
    "axpy", "scal", "waxpby", "copy", "vmul", "rot", "dot", "asum",
    "nrm2", "iamax", "axpydot", "axpydot_nodf", "ref", "KERNELS",
]

# every counted kernel wrapper, by routine name
KERNELS = {f.__name__: f for f in (axpy, scal, waxpby, copy, vmul, rot,
                                    dot, asum, nrm2, iamax, axpydot)}


def axpydot_nodf(alpha, w, v, u):
    """Non-dataflow axpydot: z is materialized in HBM between the two
    routine kernels (the paper's 'w/o DF' bar)."""
    z = axpy(-alpha, v, w)   # z = w - alpha*v
    return dot(z, u)
