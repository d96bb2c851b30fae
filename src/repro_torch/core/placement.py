"""Placement hints: JSON placement constraints -> shard specs, the port
of `repro/core/placement.py`.

The paper lets users pin kernels to AIE-array regions when the
compiler's automatic floorplan is slow or bad. The analogue here: the
JSON `placement` field names mesh dimensions per operand, and each rank
takes its block of a hinted input by that spec (`core.distributed`'s
calling convention: every rank is passed the global operands). An input
with no hint goes whole to every rank.
"""
from __future__ import annotations

from typing import Dict

from .distributed import shard


def _hints(graph):
    """(public input, hint) pairs: what the lowering's place pass
    collected (`ir.placements`) for a lowered program or ProgramIR, else
    each hinted input port of a bare DataflowGraph."""
    ir = getattr(graph, "ir", graph)
    placements = getattr(ir, "placements", None)
    if placements is not None:
        return list(placements.items())
    graph = getattr(graph, "graph", graph)
    return [(pi.name, graph.nodes[pi.routine].placement[pi.port])
            for pi in graph.inputs
            if pi.port in graph.nodes[pi.routine].placement]


def placement_shardings(graph, mesh) -> Dict[str, tuple]:
    """Public-input name -> spec tuple from the routines' placement
    hints, over a Program, a ProgramIR or a DataflowGraph. Names that
    are not dimensions of the mesh become None; two hints on one input
    that differ on this mesh raise."""
    out: Dict[str, tuple] = {}
    for name, hint in _hints(graph):
        spec = tuple(a if a in mesh.mesh_dim_names else None for a in hint)
        prev = out.get(name)
        if prev is not None and prev != spec:
            raise ValueError(
                f"conflicting placement hints for program input "
                f"{name!r}: {prev} vs {spec}")
        out[name] = spec
    return out


def apply_placement(graph, mesh, inputs: dict) -> dict:
    """This rank's block of each hinted input; the rest pass whole."""
    specs = placement_shardings(graph, mesh)
    return {name: (shard(mesh, v, specs[name]) if name in specs else v)
            for name, v in inputs.items()}
