"""Dataflow-graph IR: routines are nodes, window/stream handoffs edges.

This is the in-memory analogue of the ADF graph AIEBLAS generates: a
DAG whose nodes are routine instances and whose edges say "this output
window feeds that input port on-chip". Program inputs/outputs are the
unconnected ports (they become PL movers in the paper; HBM-resident
tensors here).

Construction is split into independently-testable pieces so
`core.lowering` can run them as named passes:

    g = DataflowGraph(spec, validate=False)   # structure only
    check_port_kinds(g)                       # edge typing
    g.order = topo_sort(g)                    # schedule / cycle check
    io = collect_io(g)                        # program boundary + kinds

`DataflowGraph(spec)` (the default, validate=True) still runs all of
them, so existing call sites keep working.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

from . import routines as R
from .spec import ProgramSpec, RoutineSpec, spec_error


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str        # routine name
    src_port: str
    dst: str
    dst_port: str


@dataclasses.dataclass(frozen=True)
class ProgramInput:
    name: str       # public name
    routine: str
    port: str
    kind: str       # "vector" | "matrix" | "scalar"


@dataclasses.dataclass(frozen=True)
class ProgramOutput:
    name: str
    routine: str
    port: str
    kind: str       # "vector" | "matrix" | "scalar"


@dataclasses.dataclass(frozen=True)
class ProgramIO:
    """The program boundary, as inferred by `collect_io`: every public
    input/output binding plus a deduped name -> kind map for each."""
    inputs: List[ProgramInput]
    outputs: List[ProgramOutput]
    input_kinds: Mapping[str, str]    # public name -> kind
    output_kinds: Mapping[str, str]


class DataflowGraph:
    def __init__(self, spec: ProgramSpec, *, validate: bool = True,
                 sink=None):
        self.spec = spec
        self.nodes: Mapping[str, RoutineSpec] = {
            r.name: r for r in spec.routines}
        self.edges: list[Edge] = []
        self.in_edges: dict[tuple, Edge] = {}   # (dst, dst_port) -> edge
        self.out_edges: dict[tuple, list] = {}  # (src, src_port) -> [edges]

        for ri, r in enumerate(spec.routines):
            for out_port, targets in r.connections.items():
                for target in targets:
                    tname, tport = target.rsplit(".", 1)
                    e = Edge(r.name, out_port, tname, tport)
                    key = (tname, tport)
                    if key in self.in_edges:
                        spec_error(
                            sink,
                            f"input port {tname}.{tport} driven twice",
                            code="RV106",
                            path=f"routines[{ri}].connections"
                                 f".{out_port}",
                            hint="each input port takes exactly one "
                                 "on-chip producer; fan-in needs an "
                                 "explicit combining routine")
                        continue
                    self.in_edges[key] = e
                    self.out_edges.setdefault(
                        (r.name, out_port), []).append(e)
                    self.edges.append(e)

        # adjacency list: src routine -> its out-edges, ordered by src
        # port for determinism. Built once so topo sort / reachability
        # are O(V + E) instead of rescanning every out_edges entry per
        # node.
        self.adj: dict[str, list] = {n: [] for n in self.nodes}
        for key in sorted(self.out_edges):
            self.adj[key[0]].extend(self.out_edges[key])

        self.order: Optional[list] = None
        self.inputs: Optional[list] = None
        self.outputs: Optional[list] = None
        if validate:
            check_port_kinds(self)
            self.order = topo_sort(self)
            io = collect_io(self)
            self.inputs, self.outputs = io.inputs, io.outputs

    # -- queries used by the fusion planner -----------------------------

    def producer_of(self, node: str, port: str) -> Optional[Edge]:
        return self.in_edges.get((node, port))

    def consumers_of(self, node: str, port: str):
        return self.out_edges.get((node, port), [])

    def input_names(self):
        seen, out = set(), []
        for i in self.inputs:
            if i.name not in seen:
                seen.add(i.name)
                out.append(i.name)
        return out

    def output_names(self):
        return [o.name for o in self.outputs]


# ---------------------------------------------------------------------------
# Validation / inference passes (invoked by core.lowering)
# ---------------------------------------------------------------------------


def _routine_index(graph: DataflowGraph, name: str) -> int:
    for i, r in enumerate(graph.spec.routines):
        if r.name == name:
            return i
    return -1


def check_port_kinds(graph: DataflowGraph, sink=None) -> None:
    """Edge typing: window outputs may only feed matching window ports;
    scalar (reduction) outputs cannot feed window ports at all."""
    for e in graph.edges:
        src_def = graph.nodes[e.src].rdef
        dst_def = graph.nodes[e.dst].rdef
        out_kind = src_def.outputs[e.src_port]
        in_kind = dst_def.inputs[e.dst_port]
        ok = (out_kind == R.OUT_VEC and in_kind == R.VEC) or \
             (out_kind == R.OUT_MAT and in_kind == R.MAT)
        if not ok:
            ri = _routine_index(graph, e.src)
            spec_error(
                sink,
                f"type mismatch on edge {e.src}.{e.src_port} "
                f"({out_kind}) -> {e.dst}.{e.dst_port} ({in_kind}); "
                f"scalar outputs cannot feed window ports",
                code="RV105",
                path=f"routines[{ri}].connections.{e.src_port}",
                hint="route scalar results through a scalar input "
                     "binding, not an on-chip window edge")


def topo_sort(graph: DataflowGraph, sink=None) -> list:
    """Deterministic topological order; raises SpecError on cycles
    (or records the cycle on `sink` and returns the acyclic prefix)."""
    indeg = {n: 0 for n in graph.nodes}
    for e in graph.edges:
        indeg[e.dst] += 1
    ready = sorted(n for n, d in indeg.items() if d == 0)
    order = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for e in graph.adj[n]:
            indeg[e.dst] -= 1
            if indeg[e.dst] == 0:
                ready.append(e.dst)
    if len(order) != len(graph.nodes):
        cyclic = sorted(set(graph.nodes) - set(order))
        spec_error(
            sink,
            f"dataflow graph has a cycle through {cyclic}",
            code="RV107", path="routines",
            hint="on-chip edges must form a DAG; break the cycle by "
                 "routing one value through program IO")
    return order


_KIND_MAP = {R.OUT_VEC: "vector", R.OUT_MAT: "matrix",
             R.OUT_SCALAR: "scalar"}


def collect_io(graph: DataflowGraph, sink=None) -> ProgramIO:
    """Infer the program boundary: unconnected ports become public
    inputs/outputs, with a deduped public-name -> kind map. Requires
    `graph.order` (run `topo_sort` first)."""
    if graph.order is None:
        graph.order = topo_sort(graph)

    inputs, in_kinds = [], {}
    for name in graph.order:
        r = graph.nodes[name]
        for port, kind in r.rdef.inputs.items():
            if (name, port) in graph.in_edges:
                continue  # driven on-chip
            public = r.input_aliases.get(port, f"{name}.{port}")
            inputs.append(ProgramInput(public, name, port, kind))
        for sname, binding in r.scalars.items():
            if binding.kind == "input":
                inputs.append(ProgramInput(
                    binding.input_name, name, sname, "scalar"))
    # aliased inputs may be shared (same public name feeding two
    # routines) — dedupe by public name, keep all (routine, port)
    # bindings, but reject one public name used at two different kinds.
    for pi in inputs:
        prev = in_kinds.get(pi.name)
        if prev is not None and prev != pi.kind:
            spec_error(
                sink,
                f"program input {pi.name!r} bound at conflicting kinds "
                f"{prev} and {pi.kind}",
                code="RV108",
                path=f"routines[{_routine_index(graph, pi.routine)}]",
                hint="give the scalar stream and the window input "
                     "distinct public names")
            continue
        in_kinds[pi.name] = pi.kind

    outputs, out_kinds = [], {}
    for name in graph.order:
        r = graph.nodes[name]
        for port, kind in r.rdef.outputs.items():
            consumed = (name, port) in graph.out_edges
            public = r.output_aliases.get(port)
            if consumed and public is None:
                continue  # internal edge only
            public = public or f"{name}.{port}"
            if public in out_kinds:
                spec_error(
                    sink,
                    f"duplicate program output name {public!r}",
                    code="RV109",
                    path=f"routines[{_routine_index(graph, name)}]"
                         f".outputs.{port}",
                    hint="alias one of the outputs to a distinct "
                         "public name")
                continue
            out_kinds[public] = _KIND_MAP[kind]
            outputs.append(ProgramOutput(public, name, port,
                                         _KIND_MAP[kind]))
    if not outputs:
        spec_error(sink, "program has no outputs", code="RV109",
                   path="routines",
                   hint="leave at least one output port unconnected "
                        "(or alias it in 'outputs')")

    return ProgramIO(inputs=inputs, outputs=outputs,
                     input_kinds=in_kinds, output_kinds=out_kinds)
