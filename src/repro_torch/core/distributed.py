"""Distributed ("multi-AIE") BLAS routines over a device mesh, the port
of `repro/core/distributed.py`.

The reference shards the operands over a JAX mesh with `shard_map`,
runs the single-core Pallas kernel on each shard and stitches the
results with collectives. The port does the same over a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions
(`launch.mesh`), one process per rank:

* every rank is passed the GLOBAL operands, as the reference's callers
  pass global arrays, and takes its own block of each by the
  reference's `in_specs` (`shard`);
* each rank runs the port's single-card kernel on its blocks;
* each rank returns its block of the result by the reference's
  `out_specs`: a result with spec `()` is the same on every rank, and
  `gather` rebuilds a sharded one.

A spec is a tuple with one entry per tensor dimension, as a
`PartitionSpec`: None (not split), a mesh-dimension name, or a tuple of
names (split over their product, the first one major).

Every psum of the reference is a reduction in a FIXED order here: an
`all_gather` of the partials over the named dimension, then a sum in
rank order. The backends fix no order for `all_reduce`; this order
makes each result bitwise the same on every rank and from run to run.

  paxpy   — row-sharded element-wise, no communication
  pdot    — row-sharded partial dots, one fixed-order sum
  paxpydot — the fused axpydot per shard, one fixed-order scalar sum
  pgemv   — 2-D sharded A, a fixed-order sum over the column dimension
  pgemm   — row x col sharded A B, no communication ("row_col"), or
            contraction-sharded with a fixed-order sum ("contract")
  distribute_program — data-parallel run of a whole level-1 Program

The sharded train step (`models/partition.py::Layout`) adds three
functions that autograd goes through, each skipping the mesh dimensions
of one rank (so a world of one runs no collective and copies nothing):

  gather_param   — a parameter whole from this rank's block; backward:
                   the gradient summed over the ranks whose gradients
                   differ, in a fixed order, and reduce-scattered onto
                   the block (`all_to_all`)
  sum_over       — forward a fixed-order sum (the loss over the batch
                   blocks, the MoE variants' output over "model");
                   backward the gradient as it is, on every rank
  replicate_over — forward the tensor as it is; backward a fixed-order
                   sum of the ranks' partial gradients

A `models.sharding.MeshShape` (names and sizes, no process group) stands
in for a mesh in the cost counter's runs (`launch.cost`): every
collective then returns empty `meta` tensors of its results' shapes and
refuses any tensor that is not on `meta`, and this rank is the one at
the MeshShape's coordinate. Every collective reports the bytes this rank
receives to the cost counter while one runs, under the reference's names
(`all-gather`, `all-reduce`, `reduce-scatter`).
"""
from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch

from ..kernels import common, ops

Entry = Union[None, str, Tuple[str, ...]]

# how each reduction's per-shard outputs combine into the global one
_COMBINE = {"dot": "sum", "asum": "sum", "coldot": "sum", "nrm2": "norm",
            "amax": "max"}


def _names(entry: Entry) -> tuple:
    if not entry:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh, names) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) over the mesh
    dimensions `names`, the first one major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"this rank is not in the mesh {mesh}")
    index, count = 0, 1
    for name in names:
        dim = mesh.mesh_dim_names.index(name)
        index = index * mesh.shape[dim] + coord[dim]
        count *= mesh.shape[dim]
    return index, count


def coordinate(mesh, name: str) -> int:
    """This rank's index along the mesh dimension `name`."""
    return _index(mesh, (name,))[0]


def _size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _stand_in(mesh, t) -> bool:
    """Whether `mesh` is a stand-in (a MeshShape); it takes `meta`
    tensors only."""
    if not getattr(mesh, "stand_in", False):
        return False
    if t.device.type != "meta":
        raise ValueError(f"{mesh} stands in for a mesh on meta tensors "
                         f"only; got one on {t.device}")
    return True


def shard(mesh, t, spec):
    """This rank's block of the global tensor `t` under `spec` (a
    contiguous copy where it is a strided view); a spec of no names
    passes it whole."""
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{t.ndim}-d operand")
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        index, count = _index(mesh, names)
        size = t.shape[dim]
        if size % count:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"split into {count} blocks over {names}")
        t = t.narrow(dim, index * (size // count), size // count)
    return t.contiguous()


def _all_gather(mesh, t, name, kind="all-gather"):
    """Every rank's `t` along the mesh dimension `name`, in group rank
    order: the order of the coordinates for a mesh over ascending ranks
    (every mesh that `launch.mesh` or `init_device_mesh` makes). `kind`
    names what the caller makes of it for the cost counter: a gather, or
    an all-reduce where it sums the parts."""
    n = _size(mesh, name)
    common.moved(kind, (n - 1) * t.numel() * t.element_size())
    parts = [torch.empty_like(t) for _ in range(n)]
    if _stand_in(mesh, t):
        return parts
    import torch.distributed as dist

    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(name))
    return parts


def _concat(mesh, t, names, dim, kind="all-gather"):
    """The blocks of every rank over `names` concatenated along `dim`
    (the innermost name first, so the first one is major)."""
    for name in reversed(names):
        t = torch.cat(_all_gather(mesh, t, name, kind), dim=dim)
    return t


def gather(mesh, local, spec):
    """The global tensor whose block on this rank is `local` under
    `spec`: the inverse of `shard`, the same on every rank."""
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if names:
            local = _concat(mesh, local, names, dim)
    return local


def partials(mesh, t, axis, kind="all-reduce"):
    """(count, *t.shape): every rank's `t` over the mesh dimension(s)
    `axis`, in mesh order (for a sum, unless `kind` says otherwise)."""
    return _concat(mesh, t.unsqueeze(0), _names(axis), 0, kind)


def psum(mesh, t, axis):
    """The sum of every rank's `t` over `axis`, added in rank order."""
    parts = partials(mesh, t, axis)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _norm(mesh, t, axis):
    """The 2-norm of the whole vector from its shards' 2-norms."""
    parts = partials(mesh, t, axis)
    total = parts[0] * parts[0]
    for p in parts[1:]:
        total = total + p * p
    return torch.sqrt(total)


def paxpy(mesh, alpha, x, y, *, axis="data"):
    """Element-wise: each rank runs the axpy kernel on its rows and
    returns them (spec `(axis,)`)."""
    return ops.axpy(alpha, shard(mesh, x, (axis,)), shard(mesh, y, (axis,)))


def pdot(mesh, x, y, *, axis="data"):
    """Partial dot per shard, then one fixed-order sum over `axis`."""
    return psum(mesh, ops.dot(shard(mesh, x, (axis,)),
                              shard(mesh, y, (axis,))), axis)


def paxpydot(mesh, alpha, w, v, u, *, axis="data"):
    """The distributed fused axpydot: each shard runs the fused kernel
    (z never leaves the chip), then one fixed-order scalar sum."""
    ws, vs, us = (shard(mesh, t, (axis,)) for t in (w, v, u))
    return psum(mesh, ops.axpydot(alpha, ws, vs, us), axis)


def pgemv(mesh, alpha, a, x, beta, y, *, row_axis="data",
          col_axis="model"):
    """A sharded (rows, cols) over the mesh, x over cols, y over rows: a
    gemv per shard and a fixed-order sum over `col_axis`; each rank
    returns its rows of y' (spec `(row_axis,)`). The first column shard
    takes beta y into its own gemv and the others take zeros, so a
    single column shard is one gemv call."""
    a_s = shard(mesh, a, (row_axis, col_axis))
    x_s = shard(mesh, x, (col_axis,))
    y_s = shard(mesh, y, (row_axis,))
    if _index(mesh, _names(col_axis))[0]:
        beta, y_s = 0.0, torch.zeros_like(y_s)
    return psum(mesh, ops.gemv(alpha, a_s, x_s, beta, y_s), col_axis)


def _matmul(a, b, tiles):
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                    device=a.device)
    return ops.gemm(1.0, a, b, 0.0, c, tiles=tiles)


def pgemm(mesh, a, b, *, strategy="row_col", row_axis="data",
          col_axis="model", block=256, tiles=None):
    """Distributed C = A B.

    row_col:  A row-sharded, B col-sharded, C (row, col)-sharded; no
              communication.
    contract: A (row, col)-sharded on (M, K), B K-sharded; a fixed-order
              sum over the contraction dimension; C row-sharded.

    `block` is the reference's Pallas tile edge and is not read: the
    port's gemm plans its own tiles (`tiles=`, a tile config for
    `kernels.gemm.gemm_plan`)."""
    if strategy == "row_col":
        return _matmul(shard(mesh, a, (row_axis, None)),
                       shard(mesh, b, (None, col_axis)), tiles)
    if strategy == "contract":
        part = _matmul(shard(mesh, a, (row_axis, col_axis)),
                       shard(mesh, b, (col_axis, None)), tiles)
        return psum(mesh, part, col_axis)
    raise ValueError(f"unknown strategy {strategy!r}; use 'row_col' or "
                     f"'contract'")


# ---------------------------------------------------------------------------
# Whole-program data parallelism (multi-AXI-port programs)
# ---------------------------------------------------------------------------


def _column_vector(pi, nodes) -> bool:
    """A vector input of a routine over matrices (colaxpy's a): one entry
    per column, so every shard takes it whole."""
    rdef = nodes[pi.routine].rdef
    return pi.kind == "vector" and "matrix" in rdef.inputs.values()


def distribute_program(prog, mesh, *, axis="data"):
    """Run a level-1 dataflow Program data-parallel over `axis`.

    Vector and matrix inputs are row-sharded (a per-column vector and the
    scalars go whole to every shard); element-wise outputs stay sharded
    (spec `(axis,)`) and each reduction's output is combined over `axis`
    by its routine: a sum for dot, asum and coldot, the square root of
    the sum of squares for nrm2 and the max for amax (spec `()`). The
    reference psums every scalar output, which gives nrm2 the sum of the
    shards' norms; an iamax output cannot be combined from the shards'
    local indices and is refused, as is a reduction consumed inside the
    program (a shard would go on with its partial). Only programs whose
    routines are all level 1 are valid: the paper's multi-AIE scope."""
    nodes = prog.graph.nodes
    for r in prog.spec.routines:
        if r.rdef.level != 1:
            raise ValueError(
                f"distribute_program supports level-1 programs only; "
                f"{r.name} is level {r.rdef.level}")
        reduces = r.blas in _COMBINE or r.blas == "iamax"
        if reduces and any(prog.graph.out_edges.get((r.name, port))
                           for port in r.rdef.outputs):
            raise ValueError(
                f"distribute_program: {r.name} ({r.blas}) feeds another "
                f"routine of the program, which would take one shard's "
                f"partial")
    combine: Mapping[str, str] = {}
    for o in prog.graph.outputs:
        blas = nodes[o.routine].blas
        if blas == "iamax":
            raise ValueError(
                f"distribute_program: output {o.name!r} comes from "
                f"{o.routine} (iamax), whose shards' local indices do not "
                f"combine into the global index")
        if blas in _COMBINE:
            combine[o.name] = _COMBINE[blas]
    whole = {pi.name for pi in prog.graph.inputs
             if pi.kind == "scalar" or _column_vector(pi, nodes)}

    def run(**inputs):
        outs = prog(**{n: (v if n in whole else shard(mesh, v, (axis,)))
                       for n, v in inputs.items()})
        result = {}
        for name in prog.output_names:
            v, rule = outs[name], combine.get(name)
            if rule == "sum":
                v = psum(mesh, v, axis)
            elif rule == "norm":
                v = _norm(mesh, v, axis)
            elif rule == "max":
                v = partials(mesh, v, axis).amax(dim=0)
            result[name] = v
        return result

    return run


# ---------------------------------------------------------------------------
# Differentiable collectives for the sharded train step
# ---------------------------------------------------------------------------


def live(mesh, names) -> tuple:
    """The names among `names` (an entry or a sequence of names) whose
    mesh dimension has more than one rank."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return tuple(n for n in _names(names) if sizes[n] > 1)


def gather_live(mesh, local, spec):
    """`gather` over the dimensions of more than one rank only (a block
    over one rank is the whole of that dimension)."""
    for dim, entry in enumerate(spec):
        names = live(mesh, entry)
        if names:
            local = _concat(mesh, local, names, dim)
    return local


def _sum_parts(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _reduce_scatter(mesh, t, name, dim):
    """This rank's chunk along `dim` (one of the mesh dimension's size,
    in coordinate order) of the sum of every rank's `t` over `name`: an
    `all_to_all` of the chunks, then a sum in rank order."""
    n = _size(mesh, name)
    x = t.movedim(dim, 0)
    if x.shape[0] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[0]} does not "
                         f"split into {n} blocks over {name!r}")
    send = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    common.moved("reduce-scatter",
                 (n - 1) * send.numel() * send.element_size() // n)
    if not _stand_in(mesh, send):
        import torch.distributed as dist

        dist.all_to_all_single(recv, send, group=mesh.get_group(name))
    # contiguous, as a block that `shard` cuts is: a strided one would sum
    # in another order where the clip takes its norm
    return _sum_parts(recv.unbind(0)).movedim(0, dim).contiguous()


def reduce_plan(mesh, spec, sum_axes):
    """How `reduce_to_block` reaches this rank's block: (first, stages,
    last). `first` is `spec` cut to the dimensions whose entries name no
    summed mesh dimension (a local cut, before any communication);
    `stages` is, in mesh order, (name, tensor dimension) for a
    reduce-scatter over `name` along that dimension, or (name, None) for
    an all-reduce over it; `last` is the spec of the local cut left at
    the end. A dimension is reduce-scattered where its entry names only
    summed mesh dimensions, in mesh order; a summed name that shares its
    entry with an unsummed one is all-reduced."""
    summed = set(live(mesh, sum_axes))
    order = [n for n in mesh.mesh_dim_names if n in summed]
    first, last, scatter = [], [], {}
    for dim, entry in enumerate(spec):
        names = live(mesh, entry)
        if not set(names) & summed:
            first.append(entry)
            last.append(None)
            continue
        first.append(None)
        if set(names) <= summed and \
                [n for n in order if n in names] == list(names):
            scatter.update({n: dim for n in names})
            last.append(None)
        else:
            last.append(entry)
    return (tuple(first), [(n, scatter.get(n)) for n in order],
            tuple(last))


def reduce_to_block(mesh, g, spec, sum_axes):
    """This rank's block under `spec` of the sum over the mesh dimensions
    `sum_axes` of every rank's whole-tensor `g`, summed one dimension at
    a time in mesh order, each in rank order (`reduce_plan`): the
    dimensions no summed rank splits are cut first, then each summed
    dimension is reduce-scattered (`all_to_all` and a sum in rank order)
    or, where its spec entry mixes summed and unsummed names, all-reduced
    (an `all_gather` and a sum in rank order), and the rest is cut at the
    end. An element's sum runs in the same order on every rank."""
    first, stages, last = reduce_plan(mesh, spec, sum_axes)
    if any(live(mesh, e) for e in first):
        g = shard(mesh, g, first)
    for name, dim in stages:
        if dim is None:
            g = _sum_parts(_all_gather(mesh, g, name, "all-reduce"))
        else:
            g = _reduce_scatter(mesh, g, name, dim)
    return shard(mesh, g, last) if any(live(mesh, e) for e in last) else g


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, spec, sum_axes):
        ctx.args = (mesh, spec, sum_axes)
        return gather_live(mesh, local, spec)

    @staticmethod
    def backward(ctx, g):
        mesh, spec, sum_axes = ctx.args
        return reduce_to_block(mesh, g, spec, sum_axes), None, None, None


def gather_param(mesh, local, spec, sum_axes):
    """The whole tensor whose block on this rank is `local` under `spec`
    (`gather`), for autograd: its gradient is summed over `sum_axes` and
    cut back to the block (`reduce_to_block`). Where neither `spec` nor
    `sum_axes` names a dimension of more than one rank, `local` itself."""
    if not live(mesh, sum_axes) and not any(live(mesh, e) for e in spec):
        return local
    return _GatherParam.apply(local, mesh, tuple(spec), tuple(sum_axes))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, names):
        return psum(mesh, t, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(mesh, t, axes):
    """The sum of every rank's `t` over `axes` in rank order (`psum`);
    its gradient passes to each rank as it is (each rank's `t` adds to
    the sum once)."""
    names = live(mesh, axes)
    return _SumOver.apply(t, mesh, names) if names else t


class _ReplicateOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, names):
        ctx.args = (mesh, names)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, names = ctx.args
        return psum(mesh, g.contiguous(), names), None, None


def replicate_over(mesh, t, axes):
    """`t`, the same on every rank of `axes`, for ranks that each compute
    part of what follows from it: its gradient is the sum of theirs in
    rank order."""
    names = live(mesh, axes)
    return _ReplicateOver.apply(t, mesh, names) if names else t
