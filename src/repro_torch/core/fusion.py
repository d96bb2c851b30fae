"""Fusion planner: partition the dataflow graph into on-chip groups.

A *fusion group* is the GPU realization of the paper's "connected
routines exchange data on-chip": every routine in a group executes in
ONE generated kernel and its intermediate windows live in registers
or shared memory only. Two group shapes exist:

* **Level-1 groups** — chains of element-wise producers ending in (or
  fanning into) reductions. These were the original planner's whole
  vocabulary.
* **Level-2 anchored groups** — a `gemv`/`symv`/`gemvt` *anchor* plus
  adjacent level-1 routines. The anchor's blocked output vector is
  produced on-chip and consumed in-register by the spliced level-1
  emitters (`symv → dot`, `gemv → axpy → nrm2`), and element-wise
  producers of the anchor's accumulator operand (`y`) are applied as
  the output block is initialised — the FBLAS observation that
  streaming a level-2 routine straight into its level-1 neighbours is
  where the HBM savings of dataflow composition actually live.
  Producers of the *reduction-axis* operand (`x`) are never absorbed:
  the anchored kernel re-reads x windows once per output block, so
  fusing an x producer would multiply its input traffic instead of
  removing a round-trip.
* **Level-3 tiled groups** — a `gemm` anchor plus columnwise panel
  routines (`colaxpy`/`coldot`). The anchor's (bm, bn) accumulator
  tile is finished on-chip and the panel emitters splice against it:
  element-wise panel epilogues rewrite the tile in-register and
  columnwise reductions fold it into (1, bn) partials, so the panel
  intermediates of a blocked Krylov step never round-trip through
  HBM. Panel routines fuse ONLY under a gemm anchor — pass 1 skips
  them, because a panel-only group would have no streamed matrix to
  tile against — and absorption walks consumer chains transitively
  (the panel routines start as singletons).

Groups must be *convex* in the DAG (no path that leaves the group and
re-enters), otherwise the fused kernel would deadlock its own input.
We merge greedily over fusable edges, rejecting merges that would
break convexity. The convexity test is incremental: the partition
tracks per-group member/descendant/ancestor unions, so it costs a
constant number of set operations per merge attempt instead of the
old rescan of every outside node against every member (O(V·(V+E))).
Schedulability (a merge must not make the group quotient cyclic) adds
a Kahn sweep, run only when the candidate group has both outside
ancestors and outside descendants — the only shape that can close a
quotient cycle.

Each anchor candidate's outcome is a `fusion.absorb` or
`fusion.reject` obs event (`repro_torch.obs`) carrying the rule that
decided it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch import obs

from .graph import DataflowGraph
from .routines import MAT, OUT_MAT, RoutineDef


def _is_tile(rdef: RoutineDef) -> bool:
    """Fusable columnwise panel routine (matrix-valued ports): only a
    2-D (gemm-anchored) group can splice it."""
    return rdef.fusable and (MAT in set(rdef.inputs.values())
                             or OUT_MAT in set(rdef.outputs.values()))


def _is_2d_anchor(rdef: RoutineDef) -> bool:
    """Anchor whose output is a matrix tile (gemm) rather than a
    blocked vector (gemv/symv/gemvt)."""
    return bool(rdef.anchor) and OUT_MAT in set(rdef.outputs.values())


@dataclasses.dataclass
class FusionGroup:
    nodes: List[str]          # topo-ordered routine names
    fused: bool               # True if >1 routine runs in one kernel
    anchor: Optional[str] = None   # level-2 member streaming the group

    def __contains__(self, name):
        return name in self.nodes


def _reachability(graph: DataflowGraph):
    """descendants[n] / ancestors[n] = nodes reachable from / reaching
    n (excl. n). Both are computed in one topo sweep each so the
    planner's convexity bookkeeping starts from O(V + E) data."""
    desc = {n: set() for n in graph.nodes}
    for n in reversed(graph.order):
        for e in graph.adj[n]:
            desc[n].add(e.dst)
            desc[n] |= desc[e.dst]
    anc = {n: set() for n in graph.nodes}
    for n in graph.order:
        for e in graph.adj[n]:
            anc[e.dst].add(n)
            anc[e.dst] |= anc[n]
    return desc, anc


class _Partition:
    """Union-find over routines with per-root member, descendant-union
    and ancestor-union sets.

    A candidate merge of groups S = A ∪ B is convex iff no outside
    node sits on a path between two members, i.e. iff
    `(desc_union(S) & anc_union(S)) - S` is empty: such a node is
    reached from one member and reaches another. Tracking the unions
    per root makes each test a constant number of set ops — the
    incremental replacement for the old full-graph rescan.

    Convexity alone is not enough: two individually-convex groups can
    still form a CYCLE in the group quotient graph (group A feeds B
    and B feeds A through disjoint node paths), which has no valid
    sequential schedule — each fused kernel would wait on the other's
    output. `try_union` therefore also rejects merges that make the
    quotient cyclic. That check is a Kahn sweep over all edges, so it
    is pre-filtered: a merged group with no outside ancestors or no
    outside descendants cannot sit on a quotient cycle, which skips
    the sweep for the common chain/sink merges."""

    def __init__(self, graph: DataflowGraph):
        desc, anc = _reachability(graph)
        self.graph = graph
        self.parent = {n: n for n in graph.nodes}
        self.members = {n: {n} for n in graph.nodes}
        self.desc = {n: set(desc[n]) for n in graph.nodes}
        self.anc = {n: set(anc[n]) for n in graph.nodes}

    def find(self, n: str) -> str:
        while self.parent[n] != n:
            self.parent[n] = self.parent[self.parent[n]]
            n = self.parent[n]
        return n

    def group(self, n: str) -> set:
        return self.members[self.find(n)]

    def _quotient_acyclic_with(self, ra: str, rb: str) -> bool:
        """Would the group quotient stay a DAG if rb merged into ra?"""
        def gid(n):
            r = self.find(n)
            return ra if r == rb else r

        nodes = {gid(n) for n in self.graph.nodes}
        indeg = {g: 0 for g in nodes}
        adj = {g: set() for g in nodes}
        for e in self.graph.edges:
            a, b = gid(e.src), gid(e.dst)
            if a != b and b not in adj[a]:
                adj[a].add(b)
                indeg[b] += 1
        ready = [g for g, d in indeg.items() if d == 0]
        seen = 0
        while ready:
            g = ready.pop()
            seen += 1
            for h in adj[g]:
                indeg[h] -= 1
                if indeg[h] == 0:
                    ready.append(h)
        return seen == len(nodes)

    def try_union(self, a: str, b: str) -> Optional[str]:
        """Merge the groups of a and b if the result is convex and the
        group quotient stays acyclic (schedulable). Returns the merged
        root, or None (state untouched; `reject_reason` then says which
        rule refused — "convexity" or "cyclic-quotient" — for the
        planner's decision events)."""
        self.reject_reason = None
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        mem = self.members[ra] | self.members[rb]
        du = self.desc[ra] | self.desc[rb]
        au = self.anc[ra] | self.anc[rb]
        if (du & au) - mem:
            self.reject_reason = "convexity"
            return None
        # quotient cycle needs traffic both INTO and OUT OF the merged
        # group; without both, skip the (linear) Kahn sweep
        if (du - mem) and (au - mem) and \
                not self._quotient_acyclic_with(ra, rb):
            self.reject_reason = "cyclic-quotient"
            return None
        self.parent[rb] = ra
        self.members[ra] = mem
        self.desc[ra] = du
        self.anc[ra] = au
        return ra


def _decision(graph, anchor, target, direction, reason):
    """One `fusion.absorb` / `fusion.reject` decision event per anchor
    candidate — the planner's reasoning, exported for `repro_torch.obs`.
    `reason is None` means the merge was accepted."""
    obs.event("fusion.absorb" if reason is None else "fusion.reject",
              program=graph.spec.name, anchor=anchor, target=target,
              direction=direction,
              **({} if reason is None else {"reason": reason}))


def _absorb_downstream(part, graph, name, anchored):
    """Absorb fusable consumer groups of the anchor's output.

    1-D anchors (gemv/symv/gemvt) look one edge out: pass 1 already
    grouped level-1 chains, so absorbing the direct consumer brings
    its whole group. 2-D anchors (gemm) instead walk consumer chains
    transitively — panel routines are pass-1 singletons — absorbing
    element-wise panel epilogues and columnwise reduction sinks, which
    both splice against the (bm, bn) accumulator tile."""
    rdef = graph.nodes[name].rdef
    two_d = _is_2d_anchor(rdef)
    frontier = [name]
    visited = set()
    while frontier:
        src = frontier.pop(0)
        if src in visited:
            continue
        visited.add(src)
        src_def = graph.nodes[src].rdef
        if src != name and not src_def.eltwise:
            continue  # reductions are sinks: nothing fuses after them
        for port in src_def.outputs:
            for e in graph.consumers_of(src, port):
                if part.find(e.dst) == part.find(name):
                    if two_d and e.dst not in visited:
                        frontier.append(e.dst)
                    continue
                cand = part.group(e.dst)
                if not all(graph.nodes[m].rdef.fusable for m in cand):
                    # contains another level-2/3 routine
                    _decision(graph, name, e.dst, "down",
                              "member-not-fusable")
                    continue
                if any(_is_tile(graph.nodes[m].rdef) for m in cand) \
                        != two_d:
                    # panel routines fuse only under a gemm anchor,
                    # and a gemm tile only splices panel routines
                    _decision(graph, name, e.dst, "down",
                              "tile-dimension-mismatch")
                    continue
                if part.find(e.dst) in anchored:
                    # already streamed by another anchor
                    _decision(graph, name, e.dst, "down",
                              "already-anchored")
                    continue
                root = part.try_union(name, e.dst)
                if root is not None:
                    anchored[root] = name
                    _decision(graph, name, e.dst, "down", None)
                    if two_d:
                        frontier.append(e.dst)
                else:
                    _decision(graph, name, e.dst, "down",
                              part.reject_reason)


def _absorb_upstream(part, graph, name, anchored):
    """Absorb an element-wise producer chain feeding the anchor's
    row-aligned accumulator operand (applied at j == 0, once per row
    block). Reductions cannot ride along — their accumulation schedule
    belongs to the finish phase — and every edge from the absorbed
    group into the anchor must target the rows port (a member also
    feeding the column-aligned port would need (bn, 1) windows the
    row-phase emitters cannot produce)."""
    rdef = graph.nodes[name].rdef
    if _is_2d_anchor(rdef):
        # no row phase in the tiled emitter: the C operand initialises
        # the (bm, bn) accumulator directly at the flush step
        return
    rows_port = rdef.anchor_ports["rows"]
    e = graph.producer_of(name, rows_port)
    if e is None:
        return
    cand = part.group(e.src)
    if not all(graph.nodes[m].rdef.eltwise for m in cand):
        _decision(graph, name, e.src, "up", "producer-not-eltwise")
        return
    if part.find(e.src) in anchored:
        _decision(graph, name, e.src, "up", "already-anchored")
        return
    for m in cand:
        for port in graph.nodes[m].rdef.outputs:
            for me in graph.consumers_of(m, port):
                if me.dst == name and me.dst_port != rows_port:
                    # the x-side producer rule: a member also feeding
                    # the column-aligned port would multiply input
                    # traffic instead of removing a round-trip
                    _decision(graph, name, e.src, "up",
                              "x-side-producer")
                    return
    root = part.try_union(name, e.src)
    if root is not None:
        anchored[root] = name
        _decision(graph, name, e.src, "up", None)
    else:
        _decision(graph, name, e.src, "up", part.reject_reason)


def plan(graph: DataflowGraph, *, enable: bool = True,
         anchor: Optional[bool] = None) -> List[FusionGroup]:
    """Partition nodes into topo-ordered fusion groups.

    enable=False produces one group per routine — the paper's
    "no-dataflow" configuration where every intermediate round-trips
    through off-chip memory. `anchor` (default: follows `enable`)
    additionally lets level-2 anchors absorb adjacent level-1 groups.
    """
    if anchor is None:
        anchor = enable
    part = _Partition(graph) if enable else None
    anchored: dict = {}       # group root -> anchor routine name

    if enable:
        # pass 1: level-1 element-wise chains into their consumers
        for e in graph.edges:
            src_def = graph.nodes[e.src].rdef
            dst_def = graph.nodes[e.dst].rdef
            if not (src_def.fusable and dst_def.fusable):
                continue
            if not src_def.eltwise:
                continue  # reductions are sinks: nothing fuses after them
            if _is_tile(src_def) or _is_tile(dst_def):
                # panel routines fuse only under a gemm anchor: a
                # panel-only group has no streamed matrix to tile
                # against, so the level-1 emitter cannot run it
                continue
            part.try_union(e.src, e.dst)

        # pass 2: level-2 anchors absorb adjacent level-1 groups. Topo
        # order so an anchor sees its consumers' final level-1 grouping.
        if anchor:
            for name in graph.order:
                if not graph.nodes[name].rdef.anchor:
                    continue
                _absorb_downstream(part, graph, name, anchored)
                _absorb_upstream(part, graph, name, anchored)

    groups: dict = {}
    for n in graph.order:  # topo order within groups for free
        root = part.find(n) if part is not None else n
        groups.setdefault(root, []).append(n)

    # schedule groups by a topo sort of the group quotient (kept
    # acyclic by try_union). Sorting by first-member topo index is NOT
    # enough: an anchor can absorb a consumer whose other operand
    # comes from a topologically later group, which must then run
    # first. Ties break on first-member topo index for determinism.
    topo_index = {n: i for i, n in enumerate(graph.order)}
    root_of = {n: (part.find(n) if part is not None else n)
               for n in graph.nodes}
    indeg = {r: 0 for r in groups}
    adj = {r: set() for r in groups}
    for e in graph.edges:
        a, b = root_of[e.src], root_of[e.dst]
        if a != b and b not in adj[a]:
            adj[a].add(b)
            indeg[b] += 1
    ready = sorted((r for r, d in indeg.items() if d == 0),
                   key=lambda r: topo_index[groups[r][0]])
    ordered = []
    while ready:
        r = ready.pop(0)
        ordered.append(r)
        changed = False
        for h in adj[r]:
            indeg[h] -= 1
            if indeg[h] == 0:
                ready.append(h)
                changed = True
        if changed:
            ready.sort(key=lambda r_: topo_index[groups[r_][0]])
    assert len(ordered) == len(groups), "group quotient has a cycle"
    return [FusionGroup(nodes=groups[r], fused=len(groups[r]) > 1,
                        anchor=anchored.get(r))
            for r in ordered]
