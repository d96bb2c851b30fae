"""One rank's cost of a call: flops, HBM bytes and collective bytes, the
port's counterpart of `repro/launch/hlo_cost.py`.

The reference walks the optimized HLO text of a compiled step (per-device
shapes, while bodies times their trip counts). The port compiles nothing:
it counts one rank's call -- a train step, a prefill or a decode step --
as it runs, ideally on `meta` stand-ins (`launch.specs`) with a
`sharding.MeshShape` standing in for the mesh, so a 256- or 512-rank
step runs on a host without allocating anything. What it counts:

  flops       -- the matmul family as `torch.utils.flop_counter` reckons
                 it (2·M·N·K), and one flop per output element of every
                 element-wise op and reduction (the reference's walker,
                 `hlo_cost.py:395-401`)
  hbm_bytes   -- each op's operand and result bytes. The port fuses
                 nothing, so every op is "top level"; a view moves
                 nothing, and slicing and index writes count only the
                 region they touch (`hlo_cost.py:382-391`)
  coll_bytes  -- the bytes this rank receives in each collective
                 (`core.distributed`), under the reference's names

Torch ops are seen by a `TorchDispatchMode`. The port's own kernels
(ctypes CUDA and Triton launches) are invisible to it; their wrappers
report (flops, bytes) reckoned from the shapes and host ints
(`kernels.common.counted(cost=)`: `mha` the visible pairs only, at
2 (d + dv) a pair; `decode_attention` the valid keys), and the torch ops
they run inside (their plain versions on CPU tensors) are not counted a
second time. So a call counts the same on `meta`, CPU and CUDA tensors.
Collectives report at their call sites in `core.distributed`. Nothing
reads a device value: the kernels' lengths come from host ints.

  count(fn, *args, **kwargs) -> (fn's result, Counted)

`Counted` holds the `Cost`, the calls of each kernel wrapper, and the
peak bytes of the storages the call made that were live at once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import common


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_detail: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def __iadd__(self, other):
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.coll_bytes += other.coll_bytes
        for k, v in other.coll_detail.items():
            self.coll_detail[k] = self.coll_detail.get(k, 0.0) + v
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.hbm_bytes * k,
                    self.coll_bytes * k,
                    {kk: v * k for kk, v in self.coll_detail.items()})


@dataclasses.dataclass
class Counted:
    cost: Cost
    kernels: Dict[str, int]       # calls of each kernel wrapper
    peak_bytes: int               # storages made by the call, live at once


# ops that move nothing: allocation without a write, and aliases
_FREE = frozenset({
    "_unsafe_view", "detach", "alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_"})
# reductions (and the softmax family): one flop per output element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "linalg_vector_norm", "norm", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "cumsum", "cumprod", "argmax", "argmin", "any", "all", "sort"})
# region reads: the result's bytes read and written
_GATHERS = frozenset({"index", "index_select", "gather", "embedding"})
# region writes: the update's bytes read and written, at this argument
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_add": 3, "index_add_": 3, "index_copy": 3,
             "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def _flat(x, out: list) -> list:
    """The leaves of an op's arguments or results (nested lists, tuples
    and dicts), each list or dict marked by its length and keys so that
    the leaves and marks together fix the structure."""
    if isinstance(x, (list, tuple)):
        out.append(len(x))
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        out.append(tuple(x))
        for y in x.values():
            _flat(y, out)
    else:
        out.append(x)
    return out


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    return [t for t in _flat(tree, []) if torch.is_tensor(t)]


def op_cost(func, args, kwargs, out) -> Cost:
    """The cost of one aten op (see the module's docstring)."""
    if func.namespace != "aten":
        return Cost()         # collectives are counted at their call sites
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE:
        return Cost()
    outs = _tensors(out)
    if name in _GATHERS:
        return Cost(0.0, 2.0 * sum(_nbytes(t) for t in outs))
    if name in _SCATTERS:
        pos = _SCATTERS[name]
        upd = args[pos] if len(args) > pos else None
        return Cost(0.0, 2.0 * _nbytes(upd))
    if name == "copy_":
        return Cost(0.0, float(_nbytes(args[0]) + _nbytes(args[1])))
    nbytes = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                   + sum(_nbytes(t) for t in outs))
    packet = func.overloadpacket
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
    elif torch.Tag.pointwise in func.tags or name in _REDUCTIONS:
        flops = outs[0].numel() if outs else 0
    else:
        flops = 0
    return Cost(float(flops), nbytes)


# in-place ops that change a tensor's shape or strides: never memoized
_RESHAPING = frozenset({"resize_", "resize_as_", "set_", "as_strided_",
                        "squeeze_", "unsqueeze_", "transpose_", "t_",
                        "swapdims_", "swapaxes_"})


def _meta_key(func, args, kwargs):
    """What a meta op's results depend on: the op, the arguments'
    structure and non-tensor values, each tensor's shape, strides, offset
    and dtype; None where an argument is not on meta or not hashable."""
    leaves = _flat(kwargs, _flat(args, []))
    key, tensors = [func], 0
    for x in leaves:
        if torch.is_tensor(x):
            if x.device.type != "meta":
                return None
            tensors += 1
            key.append((tuple(x.shape), x.stride(), x.storage_offset(),
                        x.dtype))
        else:
            key.append(x)
    key = tuple(key)
    try:
        hash(key)
    except TypeError:
        return None
    return (key, leaves) if tensors else None


class _Counter(TorchDispatchMode):
    """The dispatch mode of `count`, and the hook (`common.COUNTER`) that
    the kernel wrappers and the collectives report to.

    On meta tensors an op's results depend on the arguments' metadata
    alone, and the meta kernels (many of them Python) cost far more than
    the counting: each op's results are remembered by that metadata and
    made afresh as empty meta tensors on the next call with the same (an
    in-place op's result being its argument)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernels: Dict[str, int] = {}
        self.quiet = 0           # > 0 inside a kernel wrapper
        self.live = {}           # storage id -> (weak ref, bytes)
        self.now = self.peak = 0
        self.memo = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        found = None
        if not (func.is_view or func.overloadpacket.__name__ in _RESHAPING):
            found = _meta_key(func, args, kwargs)
        if found is None:
            out = func(*args, **kwargs)
            cost = None if self.quiet else op_cost(func, args, kwargs, out)
        else:
            key, leaves = found
            hit = self.memo.get(key)
            if hit is None:
                out = func(*args, **kwargs)
                hit = self.memo[key] = (_plan(out, leaves),
                                        op_cost(func, args, kwargs, out))
            elif hit[0] is False:
                out = func(*args, **kwargs)
            else:
                made, kind = hit[0]
                outs = [leaves[m[1]] if m[0] == "arg" else
                        torch.empty_strided(m[1], m[2], dtype=m[3],
                                            device="meta")
                        if m[0] == "new" else m[1] for m in made]
                out = outs[0] if kind is None else kind(outs)
            cost = hit[1]
        if not self.quiet:
            c = self.cost
            c.flops += cost.flops
            c.hbm_bytes += cost.hbm_bytes
            self.track(out)
        return out

    def track(self, out) -> None:
        """Add the storages of `out` that are new to the live bytes and
        keep the peak; the storages that died since are dropped (only
        when the new ones might raise the peak: until then the stale sum
        over-counts, and a peak it does not pass is not passed)."""
        new = []
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            held = self.live.get(key)
            if held is not None and not held[0].expired():
                continue
            new.append((key, st))
        if not new:
            return
        grow = sum(st.nbytes() for _, st in new)
        if self.now + grow > self.peak:
            for key in [k for k, (ref, _) in self.live.items()
                        if ref.expired()]:
                self.now -= self.live.pop(key)[1]
        for key, st in new:
            if key in self.live:          # a dead storage's reused id
                self.now -= self.live.pop(key)[1]
            self.live[key] = (StorageWeakRef(st), st.nbytes())
            self.now += st.nbytes()
        self.peak = max(self.peak, self.now)

    def kernel(self, name, cost, fn, args, kwargs):
        """A kernel wrapper's call: its (flops, bytes) counted, the torch
        ops it runs not."""
        self.quiet += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.quiet -= 1
        flops, nbytes = cost
        self.cost += Cost(float(flops), float(nbytes))
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.track(out)
        return out

    def collective(self, kind: str, nbytes: int) -> None:
        self.cost += Cost(coll_bytes=float(nbytes),
                          coll_detail={kind: float(nbytes)})


def _plan(out, leaves):
    """How to make `out` again for the same metadata: each result leaf an
    argument it is ("arg", index), a new meta tensor ("new", shape,
    strides, dtype) or a constant; False where a result shares an
    argument's storage without being it (not made again)."""
    ids = {id(x): i for i, x in enumerate(leaves) if torch.is_tensor(x)}
    stores = {x.untyped_storage()._cdata for x in leaves
              if torch.is_tensor(x)}
    if isinstance(out, (tuple, list)):
        flat, kind = list(out), type(out)
        if any(isinstance(x, (tuple, list, dict)) for x in flat):
            return False
    else:
        flat, kind = [out], None
    made = []
    for x in flat:
        if torch.is_tensor(x):
            if x.device.type != "meta":
                return False
            if id(x) in ids:
                made.append(("arg", ids[id(x)]))
            elif x.untyped_storage()._cdata in stores or \
                    x.storage_offset() != 0:
                return False
            else:
                made.append(("new", tuple(x.shape), x.stride(), x.dtype))
        else:
            made.append(("const", x))
    return made, kind


def count(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) counting its cost: (its result, `Counted`).
    The storages of the arguments are not in `peak_bytes`."""
    counter = _Counter()
    for t in _held((args, kwargs)):      # the arguments' storages: not new
        st = t.untyped_storage()
        counter.live[st._cdata] = (StorageWeakRef(st), 0)
    prev, common.COUNTER = common.COUNTER, counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        common.COUNTER = prev
    return out, Counted(counter.cost, dict(counter.kernels), counter.peak)


def _held(tree):
    """The tensors of a tree of dicts, lists and Models."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _held(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _held(v)]
    return []


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists and Models
    (each parameter once)."""
    return sum(_nbytes(t) for t in _held(tree))
