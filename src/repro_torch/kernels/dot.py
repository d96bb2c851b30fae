"""BLAS level-1 reductions (dot, asum, nrm2, iamax) for Hopper, in
Triton.

Replaces `repro/kernels/dot.py::_reduce_call` (its `pallas_call` at
dot.py:108, with `_dot_kernel` :20, `_asum_kernel` :32, `_sumsq_kernel`
:42; nrm2 = sqrt(sumsq), :136-140) and `repro/kernels/dot.py::iamax`
(:144, `_iamax_kernel` :73, `iamax_block` :53).

Bound on an H100 SXM: HBM bytes. dot at n = 2**26 float32 reads
537 MB (0.160 ms at 3.35 TB/s); nrm2, asum and iamax read 268 MB
(0.080 ms).

Design: the reference sums across a sequential grid into one
accumulator (dot.py:23-29). GPU blocks run in parallel, so each block of
the window walk (window.py) writes a float32 partial — for iamax the
block's max |x| and its first index — and the last block to finish
combines them in a fixed order, in the same launch. No float atomics:
the result repeats bitwise. The
tail is masked rather than padded (the reference pads at dot.py:99-101).
iamax keeps BLAS's first-occurrence rule inside a block (min index over
the lanes that reach the max) and across blocks (strict compare in
block order). nrm2's square root runs in the combine.

Each wrapper takes `tiles`, a `tune.TileConfig` whose `block_rows` sets
the walk's step (`window.block_of`; None: window.BLOCK); the plain
version ignores it.
"""
from __future__ import annotations

import torch

from . import common, window

# routine -> (input ports, per-element term, post function); the same
# templates feed the fused-group generator (core/routines.py)
TL_TERM = {
    "dot": (("x", "y"), "{x} * {y}", None),
    "asum": (("x",), "tl.abs({x})", None),
    "nrm2": (("x",), "{x} * {x}", "tl.sqrt"),
}


def _reduce(wrapper, name, vectors, tiles):
    inputs, term, post = TL_TERM[name]
    names = {p: f"x{i}" for i, p in enumerate(inputs)}
    body = window.WindowBody(n_scalars=0, n_inputs=len(inputs),
                             sums=((term.format(**names), post),))
    _, sums, _, folded = window.launch(name, body, (), vectors, [],
                                       block=window.block_of(tiles))
    wrapper.launches += 1
    wrapper.folded += folded
    return sums[0]


# ---------------------------------------------------------------------------
# Plain versions (float32 accumulation)
# ---------------------------------------------------------------------------


def dot_plain(x, y):
    return torch.sum(x.float() * y.float())


def asum_plain(x):
    return torch.sum(torch.abs(x.float()))


def nrm2_plain(x):
    return torch.sqrt(torch.sum(torch.square(x.float())))


def iamax_plain(x):
    # torch.argmax returns the first maximal index, BLAS's tie rule
    return torch.argmax(torch.abs(x.float())).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------


@common.counted
def dot(x, y, *, tiles=None):
    """xᵀ y with float32 accumulation; a float32 0-d tensor."""
    common.check_vectors(x, y)
    if not common.on_card(x, y):
        dot.plain_calls += 1
        return dot_plain(x, y)
    return _reduce(dot, "dot", (x, y), tiles)


@common.counted
def asum(x, *, tiles=None):
    """Σ|x_i| with float32 accumulation."""
    common.check_vectors(x)
    if not common.on_card(x):
        asum.plain_calls += 1
        return asum_plain(x)
    return _reduce(asum, "asum", (x,), tiles)


@common.counted
def nrm2(x, *, tiles=None):
    """‖x‖₂ with float32 accumulation."""
    common.check_vectors(x)
    if not common.on_card(x):
        nrm2.plain_calls += 1
        return nrm2_plain(x)
    return _reduce(nrm2, "nrm2", (x,), tiles)


@common.counted
def iamax(x, *, tiles=None):
    """Index (int32 0-d tensor) of the first element with maximal |x_i|
    (BLAS isamax)."""
    common.check_vectors(x)
    if not common.on_card(x):
        iamax.plain_calls += 1
        return iamax_plain(x)
    body = window.WindowBody(n_scalars=0, n_inputs=1, argmaxes=("x0",))
    _, _, idxs, folded = window.launch("iamax", body, (), (x,), [],
                                       block=window.block_of(tiles))
    iamax.launches += 1
    iamax.folded += folded
    return idxs[0]
