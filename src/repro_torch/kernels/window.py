"""The window walk: one Triton pass over 1-D vectors, shared by the
standalone level-1 kernels (axpy.py, dot.py, axpydot.py) and the
fused-group generator (core/codegen.py).

It takes the place of the reference's (block_rows, 128) window walk
(`repro/kernels/axpy.py::_eltwise_call`, `repro/kernels/dot.py::
_reduce_call`, `repro/kernels/axpydot.py::axpydot` and the generated
`repro/core/codegen.py::make_group_callable`). A `WindowBody` names
what one pass computes; `source` renders it as a Triton module with two
kernels, and `launch` runs them:

* `window_kernel` — a program walks one contiguous share of the
  elements in steps of BLOCK, in increasing order; the ragged end of a
  share is masked, not padded (`grid`). Inputs are loaded (streamed:
  evict-first) and widened to float32, the body's statements run in
  registers, element-wise results are rounded to their output buffer's
  dtype on store (streamed: `.cs`). A reduction accumulates per lane
  over the program's steps and writes one float32 partial per program
  (for an index reduction, the program's max |x| and the first index
  that reaches it: a strict compare over steps in increasing order,
  then the least index among the lanes that reach the max). Scalars
  that are numbers go by value; only tensor scalars are read from a
  block on the card (`scalar_args`).
* `finish_kernel` — one program that combines the partials in a fixed
  order. On the TPU the grid runs in order and a kernel carries its sum
  from step to step; blocks on a GPU run in parallel and in no order, so
  the combine is a second, tiny launch instead. It uses no atomics, and
  the program count depends only on n and the card's SM count, so a
  result is bitwise the same from run to run.

Bound: every body here moves at most a few bytes per flop, far below
the H100's ridge, so a pass is bound by HBM bytes (3.35 TB/s). The
design answers with one read of each input and one write of each
output, 16-byte vector loads (8 warps over 4096 elements: 16 float32
values a thread), and no shared memory or padding copies. The grid
depends on the body (measured on an H100 80GB HBM3; PERF.md §6):
* a body that reduces runs one wave, PROGRAMS_PER_SM programs on each
  SM with equal shares: one program per BLOCK would write 16384
  partials at 2**26 and leave the last of 15.5 waves part empty; one
  wave on 132 SMs folds 528 and ends together;
* a body that only stores runs one program per BLOCK elements: the
  one-wave walk measured slower there (a stream of short programs
  keeps more loads and stores in flight), and with no partials there is
  nothing to save.
Pipelining a program's loads (`num_stages` 2 or 3) measured no gain.

The tuning knob (`tune.TileConfig.block_rows`, family `l1`) is BLOCK,
the elements of one step of a program's walk: a power of two, passed as
a constexpr, so each value compiles its own kernel. The reducing walk's
grid and so the order of its partial sums follow it.
"""
from __future__ import annotations

import dataclasses
from numbers import Number
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs

from . import common

BLOCK = 4096          # elements per step of a program's walk
NUM_WARPS = 8
PROGRAMS_PER_SM = 4   # programs per SM of a reducing walk: one wave
SHARE_ALIGN = 16      # a program's share, in elements (64-byte starts)
FINISH_BLOCK = 1024   # partials per step of the combine


def block_of(cfg) -> int:
    """The elements per step under a tile config (`block_rows`), or
    BLOCK. Raises for a value Triton cannot walk (not a power of two)."""
    block = getattr(cfg, "block_rows", None) or BLOCK
    if block & (block - 1) or not 16 <= block <= 65536:
        raise ValueError(f"window block {block}: a power of two in "
                         f"[16, 65536]")
    return block


def footprint(body) -> Tuple[common.Footprint, ...]:
    """Shared memory per program of a walk over `body` (an estimate:
    Triton allocates it), whatever its step: the walk stages nothing
    through shared memory (a thread keeps its elements in registers); a
    reduction's cross-warp step takes at most one float32 per thread (an
    index reduction two: value and index), and the combine
    (`finish_kernel`, 4 warps) the same."""
    per = len(body.sums) + 2 * len(body.argmaxes)
    out = [common.Footprint("window_kernel", 4 * 32 * NUM_WARPS * per)]
    if per:
        out.append(common.Footprint("finish_kernel", 4 * 32 * 4 * per))
    return tuple(out)


def grid(n: int, sms: int, reduces: bool,
         block: int = BLOCK) -> Tuple[int, int]:
    """(programs, share) of a walk over n elements on a card of `sms`
    SMs, in steps of `block`. A body that reduces: at most
    PROGRAMS_PER_SM per SM and one per block of elements, each a share
    of n / programs elements rounded up to SHARE_ALIGN; the last share
    ends at n, and none is empty. A body that only stores: one program
    per block of elements."""
    if not reduces:
        return common.cdiv(n, block), block
    p = min(common.cdiv(n, block), PROGRAMS_PER_SM * sms)
    share = common.cdiv(common.cdiv(n, p), SHARE_ALIGN) * SHARE_ALIGN
    return common.cdiv(n, share), share


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
    params = (["scal_ptr"] + [f"sv{i}" for i in range(ns)] if ns else []) \
        + [f"x{i}_ptr" for i in range(ni)] + output_params(body) \
        + ["n", "share", "P", "BLOCK: tl.constexpr"] \
        + (["SDEV: tl.constexpr"] if ns else [])
    out = HEADER + [
        "@triton.jit",
        f"def window_kernel({', '.join(params)}):",
        "    pid = tl.program_id(0)",
        "    start = pid * share",
        "    end = start + share",
    ]
    for i in range(ns):
        # scalar i from the device block where bit i of SDEV is set (a
        # tensor operand), else the float32 value passed by value
        out += [f"    if SDEV & {1 << i}:",
                f"        s{i} = tl.load(scal_ptr + {i})",
                "    else:",
                f"        s{i} = sv{i}"]
    out += reduction_init(body, "BLOCK")
    out += [
        "    steps = tl.cdiv(tl.minimum(end, n) - start, BLOCK)",
        "    for k in tl.range(0, steps, num_stages=1):",
        # start (a multiple of `share`, which Triton specialises as a
        # multiple of 16) plus k BLOCK: the compiler sees 16-element
        # alignment and issues 16-byte accesses
        "        offs = start + k * BLOCK + tl.arange(0, BLOCK)",
        # two compares, each against a multiple of 16 where n is one,
        # keep the mask uniform over a 16-byte vector
        "        mask = (offs < end) & (offs < n)",
    ]
    out += [f"        x{i} = tl.load(x{i}_ptr + offs, mask=mask, other=0.0, "
            f'eviction_policy="evict_first").to(tl.float32)'
            for i in range(ni)]
    out += [f"        {line}" for line in body.lines]
    out += [f"    {line}" for line in stores_source(body)
            + reduction_step(body)]
    out += reduction_partials(body)
    out += finish_source(body)
    return "\n".join(out) + "\n"


def output_params(body) -> List[str]:
    """Kernel parameters of a body's outputs: one buffer per element-wise
    store, then the per-program partials of its reductions."""
    return [f"o{i}_ptr" for i in range(len(body.stores))] \
        + (["psum_ptr"] if body.sums else []) \
        + (["pmax_ptr", "pidx_ptr"] if body.argmaxes else [])


def stores_source(body) -> List[str]:
    """Store each element-wise output of one block (streamed: nothing
    reads it again in this pass). Expects `offs` and `mask` in scope."""
    return [f"    tl.store(o{i}_ptr + offs, ({expr})"
            f".to(o{i}_ptr.dtype.element_ty), mask=mask, "
            f'cache_modifier=".cs")' for i, expr in enumerate(body.stores)]


def reduction_init(body, size: str) -> List[str]:
    """Per-lane accumulators of a body's reductions over blocks of
    `size` (a constexpr's name): a float32 sum, or the best |value| (-1,
    below every |x|) and its index."""
    out = [f"    acc{r} = tl.zeros([{size}], dtype=tl.float32)"
           for r in range(len(body.sums))]
    for a in range(len(body.argmaxes)):
        out += [f"    best{a} = tl.full([{size}], -1.0, tl.float32)",
                f"    bidx{a} = tl.zeros([{size}], dtype=tl.int32)"]
    return out


def reduction_step(body) -> List[str]:
    """Fold one block into the accumulators. Masked lanes add 0 and read
    -1, so they stay out of every reduction; the strict compare keeps
    each lane's earliest block."""
    out = [f"    acc{r} += tl.where(mask, {term}, 0.0)"
           for r, (term, _) in enumerate(body.sums)]
    for a, val in enumerate(body.argmaxes):
        out += [
            f"    a{a} = tl.where(mask, tl.abs({val}), -1.0)",
            f"    better{a} = a{a} > best{a}",
            f"    bidx{a} = tl.where(better{a}, offs, bidx{a})",
            f"    best{a} = tl.where(better{a}, a{a}, best{a})",
        ]
    return out


def reduction_partials(body) -> List[str]:
    """Write one partial per reduction for this program (`pid` of `P`):
    the lanes' sum, or the max over lanes and the least index among the
    lanes that reach it."""
    out = [f"    tl.store(psum_ptr + {r} * P + pid, tl.sum(acc{r}, axis=0))"
           for r in range(len(body.sums))]
    for a in range(len(body.argmaxes)):
        out += [
            f"    m{a} = tl.max(best{a}, axis=0)",
            f"    tl.store(pmax_ptr + {a} * P + pid, m{a})",
            f"    tl.store(pidx_ptr + {a} * P + pid, tl.min(tl.where("
            f"best{a} == m{a}, bidx{a}, {common.INT32_MAX}), axis=0))",
        ]
    return out


def epilogue_source(body, size: str) -> List[str]:
    """The end of a kernel whose program owns one block of `size`
    elements: store each element-wise output and write one partial per
    reduction. Expects `pid`, `offs` (global element indices), `mask`
    and `P` (programs) in scope; the anchored generator's (anchored.py),
    whose bodies carry the same `stores`, `sums` and `argmaxes`."""
    return (stores_source(body) + reduction_init(body, size)
            + reduction_step(body) + reduction_partials(body))


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
        # lane j walks partials j, j + FBLOCK, ... in program order (and
        # so in element order); the strict compare keeps each lane's
        # earliest program, and the final min over tied lanes keeps the
        # first index overall
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


def scalar_args(values: Sequence, dev: torch.device,
                round_to: Optional[torch.dtype] = None):
    """A launch's scalars: numbers go by value as float32 (rounded to
    `round_to` first, as `common.scalar_block` rounds them), so that a
    call with host scalars copies nothing to the card; tensors are read
    on the card from a block that `common.scalar_block` fills. Returns
    (that block or None, the by-value floats, the mask of the scalars
    read from the block). While `repro_torch.obs` records: a
    `window.scalars` span, and the `window.copies` counter bumped by the
    copies the block costs on the card: its pinned upload, one copy for
    each tensor scalar on the card and two for one elsewhere."""
    with obs.span_with("window.scalars"):
        mask = sum(1 << i for i, v in enumerate(values)
                   if not isinstance(v, Number))
        host = [float(v) if isinstance(v, Number) else 0.0 for v in values]
        if round_to is not None and round_to != torch.float32:
            host = torch.tensor(host).to(round_to).float().tolist()
        block = common.scalar_block(values, dev, round_to) if mask else None
        if mask and obs.enabled() and dev.type != "cpu":
            obs.counter("window.copies", 1 + sum(
                1 if getattr(v, "device", None) == dev else 2
                for v in values if not isinstance(v, Number)))
        return block, host, mask


def launch(stem: str, body: WindowBody, scalars: Sequence,
           inputs: Sequence[torch.Tensor],
           out_dtypes: Sequence[torch.dtype],
           round_to: Optional[torch.dtype] = None, block: int = BLOCK):
    """Run one window pass on the card, in steps of `block` elements.
    `scalars` are the body's scalar operands (numbers or 0-d tensors),
    rounded to `round_to` when given.

    Returns (element-wise outputs, (len(sums),) float32 results or None,
    (len(argmaxes),) int32 indices or None, number of finish launches).
    While `repro_torch.obs` records, the whole pass is one
    `window.launch` span (buffers, grid, both launches).
    """
    with obs.span_with("window.launch"):
        for v in inputs:
            if not v.is_contiguous():
                raise ValueError("window kernels take contiguous vectors")
        mod = load(stem, body)
        n = inputs[0].shape[0]
        dev = inputs[0].device
        reduces = bool(body.sums or body.argmaxes)
        p, share = grid(n, common.sm_count(dev), reduces, block)
        outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
        partials, finals, sums, idxs = reduction_buffers(body, p, dev)
        args, flags = list(inputs) + outs, {}
        if body.n_scalars:
            sblock, values, mask = scalar_args(scalars, dev, round_to)
            # with no tensor scalar the block pointer is never read
            args = [inputs[0] if sblock is None else sblock, *values] + args
            flags["SDEV"] = mask
        mod.window_kernel[(p,)](*args, *partials, n, share, p, BLOCK=block,
                                num_warps=NUM_WARPS, **flags)
        return outs, sums, idxs, finish(mod, body, finals, p)
