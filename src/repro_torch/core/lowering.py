"""Lowering: named compiler passes over a ProgramIR, plus a program
cache.

The pass pipeline (the GPU analogue of AIEBLAS's generator stages in
Fig. 1), each pass independently invocable and testable:

    parse      raw JSON -> ProgramSpec            (spec layer)
    graph      ProgramSpec -> DataflowGraph       (structure only)
    infer      port-kind checking, topo schedule, program-boundary IO
    fuse       fusion planning (on-chip groups)
    place      placement-hint annotation
    emit       Triton codegen -> python callable

`lower()` runs the pipeline; `compile_cached()` memoizes whole IRs by
(spec digest, mode, fuse, anchor, device), so a spec lowered twice
compiles once.

Not ported yet: tuned tile plans (`tiles` resolves only to the kernel
defaults; the tuning store is ROADMAP Queue 1, item 12), the static
analyzer behind `verify=` (item 11), and loop lowering (`lower_loop`,
slice 3).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Callable, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.kernels.common import resolve_device

from . import codegen, fusion, spec as spec_mod
from .graph import (DataflowGraph, ProgramIO, check_port_kinds,
                    collect_io, topo_sort)
from .spec import SpecError

# ---------------------------------------------------------------------------
# ProgramIR + passes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProgramIR:
    """Everything the pipeline knows about one program, accreted by the
    passes below. `fn` is the emitted callable (inputs dict -> outputs
    dict)."""
    raw: Mapping
    digest: str
    mode: str
    fuse: bool
    anchor: bool                     # level-2 anchored fusion enabled
    device: Optional[torch.device]   # resolved by the emit pass
    spec: Optional[spec_mod.ProgramSpec] = None
    graph: Optional[DataflowGraph] = None
    io: Optional[ProgramIO] = None
    groups: Optional[list] = None
    placements: Optional[Mapping] = None
    fn: Optional[Callable] = None
    passes_run: List[str] = dataclasses.field(default_factory=list)


def parse_pass(ir: ProgramIR) -> None:
    ir.spec = spec_mod.parse(ir.raw)


def graph_pass(ir: ProgramIR) -> None:
    ir.graph = DataflowGraph(ir.spec, validate=False)


def infer_pass(ir: ProgramIR) -> None:
    """Shape/kind inference: edge typing, topo schedule, boundary IO."""
    check_port_kinds(ir.graph)
    ir.graph.order = topo_sort(ir.graph)
    ir.io = collect_io(ir.graph)
    ir.graph.inputs, ir.graph.outputs = ir.io.inputs, ir.io.outputs


def fuse_pass(ir: ProgramIR) -> None:
    ir.groups = fusion.plan(ir.graph, enable=ir.fuse, anchor=ir.anchor)


def place_pass(ir: ProgramIR) -> None:
    """Collect per-public-input placement hints (mesh-axis names), kept
    for the distributed layer (ROADMAP Queue 1, item 13)."""
    hints = {}
    for pi in ir.io.inputs:
        hint = ir.graph.nodes[pi.routine].placement.get(pi.port)
        if hint is None:
            continue
        prev = hints.get(pi.name)
        if prev is not None and prev != hint:
            raise SpecError(
                f"conflicting placement hints for program input "
                f"{pi.name!r}: {prev} vs {hint}")
        hints[pi.name] = hint
    ir.placements = hints


def emit_pass(ir: ProgramIR) -> None:
    ir.device = resolve_device(ir.device)
    ir.fn = codegen.emit_program(ir.graph, ir.groups, ir.mode)


PIPELINE: Tuple = (
    ("parse", parse_pass),
    ("graph", graph_pass),
    ("infer", infer_pass),
    ("fuse", fuse_pass),
    ("place", place_pass),
    ("emit", emit_pass),
)


def _canonical_raw(raw: Union[str, Mapping, pathlib.Path]) -> Mapping:
    if isinstance(raw, pathlib.Path):
        raw = json.loads(raw.read_text())
    elif isinstance(raw, str):
        raw = json.loads(raw)
    if not isinstance(raw, Mapping):
        raise SpecError(f"spec must be a mapping, got {type(raw)}")
    return raw


def spec_digest(raw: Union[str, Mapping, pathlib.Path]) -> str:
    """Stable content digest of a raw spec (key order independent)."""
    canon = json.dumps(_canonical_raw(raw), sort_keys=True,
                       separators=(",", ":"), default=repr)
    return hashlib.sha256(canon.encode()).hexdigest()


def _check_tiles(tiles) -> None:
    if tiles not in (None, "default"):
        raise NotImplementedError(
            f"tiles={tiles!r}: the port runs its kernels' default block "
            f"sizes; tuned tile plans come with ROADMAP Queue 1, item 12")


def lower(raw, *, mode: str = "dataflow", fuse: Optional[bool] = None,
          anchor: Optional[bool] = None, upto: Optional[str] = None,
          device=None, tiles="default", verify: bool = True) -> ProgramIR:
    """Run the pass pipeline over a raw spec. `upto` stops after the
    named pass (inclusive) for partial lowering in tests/tools.
    `anchor` gates level-2 anchored fusion groups (default: follows
    `fuse`, so dataflow mode gets them and nodataflow does not).
    `device` (default: the CUDA card) is resolved by the emit pass.
    `verify` is accepted for call-site compatibility with the reference;
    the static analyzer it runs there is ROADMAP Queue 1, item 11."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_tiles(tiles)
    raw = _canonical_raw(raw)
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    if anchor and not fuse:
        raise ValueError(
            "anchor=True requires fuse=True: level-2 anchored groups "
            "are a tier of the fusion planner, not a standalone pass")
    ir = ProgramIR(raw=raw, digest=spec_digest(raw), mode=mode,
                   fuse=fuse, anchor=anchor, device=device)
    known = [name for name, _ in PIPELINE]
    if upto is not None and upto not in known:
        raise ValueError(f"unknown pass {upto!r}; pipeline: {known}")
    for name, p in PIPELINE:
        p(ir)
        ir.passes_run.append(name)
        if name == upto:
            break
    return ir


# ---------------------------------------------------------------------------
# Program cache
# ---------------------------------------------------------------------------

_CACHE: dict = {}
_STATS = {"hits": 0, "misses": 0}


def compile_cached(raw, *, mode: str = "dataflow",
                   fuse: Optional[bool] = None,
                   anchor: Optional[bool] = None, device=None,
                   tiles="default", verify: bool = True) -> ProgramIR:
    """Fully lower a spec, memoized by (digest, mode, fuse, anchor,
    device). Loop programs reuse body specs, and the cache makes each
    distinct body compile once per configuration."""
    _check_tiles(tiles)
    raw = _canonical_raw(raw)
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    device = resolve_device(device)
    key = (spec_digest(raw), mode, fuse, anchor, str(device))
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    _STATS["misses"] += 1
    ir = lower(raw, mode=mode, fuse=fuse, anchor=anchor, device=device,
               verify=verify)
    _CACHE[key] = ir
    return ir


def cache_stats() -> Mapping[str, int]:
    """Program-cache hit/miss/size counters."""
    return dict(_STATS, size=len(_CACHE))


def clear_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0
