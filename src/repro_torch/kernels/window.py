"""The window walk: one Triton pass over 1-D vectors, shared by the
standalone level-1 kernels (axpy.py, dot.py, axpydot.py) and the
fused-group generator (core/codegen.py).

It takes the place of the reference's (block_rows, 128) window walk
(`repro/kernels/axpy.py::_eltwise_call`, `repro/kernels/dot.py::
_reduce_call`, `repro/kernels/axpydot.py::axpydot` and the generated
`repro/core/codegen.py::make_group_callable`). A `WindowBody` names
what one pass computes; `source` renders it as a Triton module and
`launch` runs it as one launch, `window_kernel`:

* a program walks one contiguous share of the elements in steps of
  BLOCK, in increasing order; the ragged end of a share is masked, not
  padded (`grid`). Inputs are loaded (streamed: evict-first) and widened
  to float32, the body's statements run in registers, element-wise
  results are rounded to their output buffer's dtype on store
  (streamed: `.cs`).
* A reduction accumulates per lane over the program's steps and writes
  one float32 partial per program (for an index reduction, the
  program's max |x| and the first index that reaches it: a strict
  compare over steps in increasing order, then the least index among the
  lanes that reach the max). On the TPU the grid runs in order and a
  kernel carries its sum from step to step; blocks on a GPU run in
  parallel and in no order, so the last program to finish combines the
  partials: each program takes a ticket (an acq_rel atomic on an int32,
  after a barrier, as csrc/gemv.cu's `last_ticket`), and the one that
  draws ticket P - 1 combines partials 0 .. P - 1 in a fixed order
  (loads through L2: an earlier pass's fold on the same SM may hold
  those addresses in L1), writes the result and resets the ticket. The
  ticket is the only atomic, and the program count depends only on n
  and the card's SM count, so a result is bitwise the same from run to
  run, whichever program folds.
* Scalars that are numbers go by value; a tensor scalar is read by the
  kernel where it lives, with the rounding `common.scalar_block` would
  apply, unless it lies on another device or is not floating: only then
  is it copied into a block on the card (`scalar_args`).

`finish_source` and `finish` keep the combine as a second launch
(`finish_kernel`) for the anchored and tiled generators' own kernels.

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

from . import common, cuda

BLOCK = 4096          # elements per step of a program's walk
NUM_WARPS = 8
PROGRAMS_PER_SM = 4   # programs per SM of a reducing walk: one wave
SHARE_ALIGN = 16      # a program's share, in elements (64-byte starts)
FINISH_BLOCK = 1024   # partials per step of the combine
# the RND code of a launch's `round_to` (`source`): the roundings the
# kernel applies to a tensor scalar it reads in place (float32 and
# float64 change no float32 value)
ROUNDING = {None: 0, torch.float32: 0, torch.float64: 0,
            torch.bfloat16: 1, torch.float16: 2}
# tensor scalars the kernel reads in place: one element of these dtypes
IN_PLACE = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


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
    index reduction two: value and index), and so does the last
    program's combine, whose steps come after the walk's."""
    per = len(body.sums) + 2 * len(body.argmaxes)
    return (common.Footprint("window_kernel", 4 * 32 * NUM_WARPS * per),)


def finish_footprint(body) -> Tuple[common.Footprint, ...]:
    """Shared memory of `finish_kernel` (4 warps) over `body`'s
    partials, the same per-thread bound; nothing for a body with no
    reduction."""
    per = len(body.sums) + 2 * len(body.argmaxes)
    return (common.Footprint("finish_kernel", 4 * 32 * 4 * per),) \
        if per else ()


def fold_block(sms: int) -> int:
    """The lanes of the last program's combine on a card of `sms` SMs:
    the least power of two that holds a reducing walk's programs (at
    most PROGRAMS_PER_SM per SM, `grid`), so the combine reads them all
    at once: a loop over blocks of them measured 5-6 µs slower in the
    iamax walk on an H100 (PERF.md §6)."""
    return 1 << (PROGRAMS_PER_SM * sms - 1).bit_length()


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
    """The Triton module for one window pass: `window_kernel`, whose
    last program folds the partials of a body that reduces."""
    ns, ni = body.n_scalars, body.n_inputs
    reduces = bool(body.sums or body.argmaxes)
    pointers = [f"sp{i}" for i in range(ns)]
    params = pointers + [f"sv{i}" for i in range(ns)] \
        + [f"x{i}_ptr" for i in range(ni)] + output_params(body) \
        + (["osum_ptr"] if body.sums else []) \
        + (["oidx_ptr"] if body.argmaxes else []) \
        + (["tick_ptr"] if reduces else []) \
        + ["n", "share", "P", "BLOCK: tl.constexpr"] \
        + (["FBLOCK: tl.constexpr"] if reduces else []) \
        + (["SDEV: tl.constexpr", "RND: tl.constexpr"] if ns else [])
    # a scalar's address is not specialised on its alignment: one
    # compiled kernel serves a 0-d view at any offset of its storage
    jit = f"@triton.jit(do_not_specialize={pointers})" if ns \
        else "@triton.jit"
    out = HEADER + [
        jit,
        f"def window_kernel({', '.join(params)}):",
        "    pid = tl.program_id(0)",
        "    start = pid * share",
        "    end = start + share",
    ]
    for i in range(ns):
        # scalar i read where bit i of SDEV is set (a tensor operand, in
        # its own storage or a block's element) and rounded as RND says,
        # else the float32 value passed by value
        out += [f"    if SDEV & {1 << i}:",
                f"        s{i} = tl.load(sp{i}).to(tl.float32)",
                "        if RND == 1:",
                f"            s{i} = s{i}.to(tl.bfloat16).to(tl.float32)",
                "        if RND == 2:",
                f"            s{i} = s{i}.to(tl.float16).to(tl.float32)",
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
    if reduces:
        # the partial stores of every thread before the ticket; the
        # program that draws the last ticket sees every program's
        out += ["    tl.debug_barrier()",
                '    ticket = tl.atomic_add(tick_ptr, 1, sem="acq_rel")',
                "    if ticket == P - 1:"] + fold_source(body)
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


def fold_source(body) -> List[str]:
    """The combine made by the program that draws the last ticket, at
    two levels of indent, then the ticket's reset. Every partial lies in
    one block of FBLOCK lanes (`fold_block`: the walk never has more
    programs), read through L2 (an earlier pass's fold on this SM may
    hold those addresses in L1): the sums in a fixed order; for an index
    reduction the max over the programs' maxima and the least index
    among the programs that reach it, the first in element order. Its
    names start with `f`, apart from the walk's, whose types differ."""
    load = ("tl.load({} + {} * P + flanes, mask=fmask, other={}, "
            'cache_modifier=".cg")')
    out = ["        flanes = tl.arange(0, FBLOCK)",
           "        fmask = flanes < P"]
    for r, (_, post) in enumerate(body.sums):
        total = f"tl.sum({load.format('psum_ptr', r, '0.0')}, axis=0)"
        out.append(f"        tl.store(osum_ptr + {r}, "
                   f"{f'{post}({total})' if post else total})")
    for a in range(len(body.argmaxes)):
        out += [
            f"        fm{a} = {load.format('pmax_ptr', a, '-2.0')}",
            f"        fi{a} = {load.format('pidx_ptr', a, '0')}",
            f"        ftop{a} = tl.max(fm{a}, axis=0)",
            f"        tl.store(oidx_ptr + {a}, tl.min(tl.where(fm{a} == "
            f"ftop{a}, fi{a}, {common.INT32_MAX}), axis=0))",
        ]
    return out + ["        tl.store(tick_ptr, 0)"]


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
    """A launch's scalars. Numbers go by value as float32 (rounded to
    `round_to` first, as `common.scalar_block` rounds them). A tensor of
    one element, on `dev` and of an `IN_PLACE` dtype, is read by the
    kernel from its own storage, rounded there (`ROUNDING`): nothing is
    copied. Any other tensor (on another device, not floating, or under
    a `round_to` the kernel does not apply) is read from a block that
    `common.scalar_block` fills. Returns (for each scalar the tensor the
    kernel reads it from, or None for a number; the by-value floats;
    the mask of the scalars the kernel reads). While `repro_torch.obs`
    records: a `window.scalars` span; on the card, where a scalar is a
    tensor, the `window.in_place` counter bumped by the tensors read in
    place and `window.copies` by the copies the block costs (0 without
    one): its pinned upload, one copy for each tensor scalar on the card
    and two for one elsewhere."""
    with obs.span_with("window.scalars"):
        host = [float(v) if isinstance(v, Number) else 0.0 for v in values]
        if round_to not in (None, torch.float32) and any(
                isinstance(v, Number) for v in values):
            host = torch.tensor(host).to(round_to).float().tolist()
        ptrs, blocked = [], []
        for i, v in enumerate(values):
            own = (torch.is_tensor(v) and v.device == dev
                   and v.dtype in IN_PLACE and v.numel() == 1
                   and round_to in ROUNDING)
            ptrs.append(v if own else None)
            if not (own or isinstance(v, Number)):
                blocked.append(i)
        if blocked:
            block = common.scalar_block(values, dev, round_to)
            for i in blocked:
                ptrs[i] = block[i]
        mask = sum(1 << i for i, t in enumerate(ptrs) if t is not None)
        if mask and obs.enabled() and dev.type != "cpu":
            copies = 1 + sum(
                1 if getattr(values[i], "device", None) == dev else 2
                for i in blocked) if blocked else 0
            obs.counter("window.in_place",
                        sum(t is v for t, v in zip(ptrs, values)))
            obs.counter("window.copies", copies)
        return ptrs, host, mask


def launch(stem: str, body: WindowBody, scalars: Sequence,
           inputs: Sequence[torch.Tensor],
           out_dtypes: Sequence[torch.dtype],
           round_to: Optional[torch.dtype] = None, block: int = BLOCK):
    """Run one window pass on the card, in steps of `block` elements:
    one launch. `scalars` are the body's scalar operands (numbers or
    tensors of one element), rounded to `round_to` when given.

    Returns (element-wise outputs, (len(sums),) float32 results or None,
    (len(argmaxes),) int32 indices or None, 1 where the pass folded a
    reduction's partials in its last program, else 0). While
    `repro_torch.obs` records, the whole pass is one `window.launch`
    span (buffers, grid, tickets, the launch).
    """
    with obs.span_with("window.launch"):
        for v in inputs:
            if not v.is_contiguous():
                raise ValueError("window kernels take contiguous vectors")
        mod = load(stem, body)
        n = inputs[0].shape[0]
        dev = inputs[0].device
        reduces = bool(body.sums or body.argmaxes)
        sms = common.sm_count(dev)
        p, share = grid(n, sms, reduces, block)
        outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
        partials, _, sums, idxs = reduction_buffers(body, p, dev)
        args, flags = list(inputs) + outs + partials, {}
        if reduces:
            args += [t for t in (sums, idxs) if t is not None]
            args.append(cuda.tickets(dev, 1))
            flags["FBLOCK"] = fold_block(sms)
        if body.n_scalars:
            ptrs, values, mask = scalar_args(scalars, dev, round_to)
            # a number's pointer is never read
            args = [inputs[0] if t is None else t for t in ptrs] \
                + values + args
            flags.update(SDEV=mask, RND=ROUNDING.get(round_to, 0))
        mod.window_kernel[(p,)](*args, n, share, p, BLOCK=block,
                                num_warps=NUM_WARPS, **flags)
        return outs, sums, idxs, int(reduces)
