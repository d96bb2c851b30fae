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
"""
from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch

from ..kernels import ops

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


def _all_gather(mesh, t, name):
    """Every rank's `t` along the mesh dimension `name`, in group rank
    order: the order of the coordinates for a mesh over ascending ranks
    (every mesh that `launch.mesh` or `init_device_mesh` makes)."""
    import torch.distributed as dist

    group = mesh.get_group(name)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _concat(mesh, t, names, dim):
    """The blocks of every rank over `names` concatenated along `dim`
    (the innermost name first, so the first one is major)."""
    for name in reversed(names):
        t = torch.cat(_all_gather(mesh, t, name), dim=dim)
    return t


def gather(mesh, local, spec):
    """The global tensor whose block on this rank is `local` under
    `spec`: the inverse of `shard`, the same on every rank."""
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if names:
            local = _concat(mesh, local, names, dim)
    return local


def partials(mesh, t, axis):
    """(count, *t.shape): every rank's `t` over the mesh dimension(s)
    `axis`, in mesh order."""
    return _concat(mesh, t.unsqueeze(0), _names(axis), 0)


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
