"""BLAS level-1 element-wise kernels (axpy, scal, waxpby, copy, vmul,
rot) for Hopper, in Triton.

Replaces `repro/kernels/axpy.py::_eltwise_call` (its `pallas_call` at
axpy.py:58, kernel bodies at axpy.py:20-44).

Bound on an H100 SXM: each routine reads its vectors once and writes
its outputs once at under 0.5 flop/byte, so HBM bytes bound it. axpy at
n = 2**26 float32 moves 805 MB: 0.240 ms at 3.35 TB/s.

Design: each routine is one `tl` expression template (`TL_EXPR`),
spliced into the shared masked window walk (window.py) — the same
templates the fused-group generator splices (core/routines.py), so the
dataflow and nodataflow paths cannot drift apart. As in the reference
(axpy.py:66) the scalars are first cast to the vector's dtype; the
kernel widens everything to float32 and rounds the result once.
"""
from __future__ import annotations

import torch

from . import common, window

# routine -> (scalar names, input ports, one template per output)
TL_EXPR = {
    "axpy": (("alpha",), ("x", "y"), ("{alpha} * {x} + {y}",)),
    "scal": (("alpha",), ("x",), ("{alpha} * {x}",)),
    "waxpby": (("alpha", "beta"), ("x", "y"),
               ("{alpha} * {x} + {beta} * {y}",)),
    "copy": ((), ("x",), ("{x}",)),
    "vmul": ((), ("x", "y"), ("{x} * {y}",)),
    "rot": (("c", "s"), ("x", "y"),
            ("{c} * {x} + {s} * {y}", "{c} * {y} - {s} * {x}")),
}


def _body(name: str) -> window.WindowBody:
    scalars, inputs, templates = TL_EXPR[name]
    names = {s: f"s{i}" for i, s in enumerate(scalars)}
    names.update({p: f"x{i}" for i, p in enumerate(inputs)})
    return window.WindowBody(
        n_scalars=len(scalars), n_inputs=len(inputs),
        stores=tuple(t.format(**names) for t in templates))


def _launch(wrapper, name, scalars, vectors):
    x = vectors[0]
    scal = (common.scalar_block(scalars, x.device, round_to=x.dtype)
            if scalars else None)
    body = _body(name)
    outs, _, _, _ = window.launch(name, body, scal, vectors,
                                  [x.dtype] * len(body.stores))
    wrapper.launches += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar rounded to `like`'s dtype, as a float32 0-d tensor."""
    return common.scalar_block([value], like.device, round_to=like.dtype)[0]


# ---------------------------------------------------------------------------
# Plain versions (float32 arithmetic, one rounding to the vector dtype)
# ---------------------------------------------------------------------------


def axpy_plain(alpha, x, y):
    return (_scalar(alpha, x) * x.float() + y.float()).to(x.dtype)


def scal_plain(alpha, x):
    return (_scalar(alpha, x) * x.float()).to(x.dtype)


def waxpby_plain(alpha, x, beta, y):
    return (_scalar(alpha, x) * x.float()
            + _scalar(beta, x) * y.float()).to(x.dtype)


def copy_plain(x):
    return x.clone()


def vmul_plain(x, y):
    return (x.float() * y.float()).to(x.dtype)


def rot_plain(c, s, x, y):
    c, s = _scalar(c, x), _scalar(s, x)
    xf, yf = x.float(), y.float()
    return (c * xf + s * yf).to(x.dtype), (c * yf - s * xf).to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------


@common.counted
def axpy(alpha, x, y):
    """y' = alpha * x + y."""
    common.check_vectors(x, y)
    if not common.on_card(x, y):
        axpy.plain_calls += 1
        return axpy_plain(alpha, x, y)
    return _launch(axpy, "axpy", (alpha,), (x, y))


@common.counted
def scal(alpha, x):
    """x' = alpha * x."""
    common.check_vectors(x)
    if not common.on_card(x):
        scal.plain_calls += 1
        return scal_plain(alpha, x)
    return _launch(scal, "scal", (alpha,), (x,))


@common.counted
def waxpby(alpha, x, beta, y):
    """w = alpha * x + beta * y."""
    common.check_vectors(x, y)
    if not common.on_card(x, y):
        waxpby.plain_calls += 1
        return waxpby_plain(alpha, x, beta, y)
    return _launch(waxpby, "waxpby", (alpha, beta), (x, y))


@common.counted
def copy(x):
    """y = x (BLAS scopy)."""
    common.check_vectors(x)
    if not common.on_card(x):
        copy.plain_calls += 1
        return copy_plain(x)
    return _launch(copy, "copy", (), (x,))


@common.counted
def vmul(x, y):
    """out = x ⊙ y (Hadamard product)."""
    common.check_vectors(x, y)
    if not common.on_card(x, y):
        vmul.plain_calls += 1
        return vmul_plain(x, y)
    return _launch(vmul, "vmul", (), (x, y))


@common.counted
def rot(c, s, x, y):
    """Givens plane rotation: returns (c x + s y, c y - s x)."""
    common.check_vectors(x, y)
    if not common.on_card(x, y):
        rot.plain_calls += 1
        return rot_plain(c, s, x, y)
    return _launch(rot, "rot", (c, s), (x, y))
