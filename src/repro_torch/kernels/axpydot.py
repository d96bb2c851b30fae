"""Fused `axpydot` — the paper's flagship dataflow composition — for
Hopper, in Triton:

    z = w - alpha * v        (axpy)
    beta = zᵀ u              (dot)

Replaces `repro/kernels/axpydot.py::axpydot` (its `pallas_call` at
axpydot.py:54, `_axpydot_kernel` :27).

Bound on an H100 SXM: HBM bytes. At n = 2**26 float32 it reads three
vectors, 805 MB: 0.240 ms at 3.35 TB/s. The unfused twin
(`ops.axpydot_nodf`) also writes z and reads it back, five vector
passes: 0.401 ms.

Design: one window walk (window.py) computes each block of z in
registers and folds it straight into the block's float32 partial of
zᵀu, so z never reaches HBM; a fixed-order combine launch finishes the
partials. alpha and the arithmetic are float32, as in the reference.
"""
from __future__ import annotations

import torch

from . import common, window

_BODY = window.WindowBody(
    n_scalars=1, n_inputs=3,            # s0 = alpha; x0, x1, x2 = w, v, u
    lines=("z = x0 - s0 * x1",),
    sums=(("z * x2", None),))


def axpydot_plain(alpha, w, v, u):
    a = common.scalar_block([alpha], w.device)[0]
    return torch.sum((w.float() - a * v.float()) * u.float())


@common.counted
def axpydot(alpha, w, v, u):
    """beta = (w - alpha v)ᵀ u with float32 accumulation."""
    common.check_vectors(w, v, u)
    if not common.on_card(w, v, u):
        axpydot.plain_calls += 1
        return axpydot_plain(alpha, w, v, u)
    scal = common.scalar_block([alpha], w.device)
    _, sums, _, finished = window.launch("axpydot", _BODY, scal,
                                         (w, v, u), [])
    axpydot.launches += 1
    axpydot.finish_launches += finished
    return sums[0]
