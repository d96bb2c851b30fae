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
(spec digest, mode, fuse, anchor, device, tile-plan key), so a spec
lowered twice compiles once. Each pass is a `lowering.<pass>` obs span,
a completed lowering a `lowering.done` event and each cache lookup a
`lowering.cache.hit` / `.miss` counter (`repro_torch.obs`, recorded
only while recording is on).

Both run the static analyzer first (`verify=True`, the default:
`repro_torch.verify.check`), so a malformed spec fails with one
`VerifyError` that lists every finding before anything is compiled;
`verify=False` raises at the first site, as lowering always did.

Tile resolution (`tiles=`, `resolve_tiles`) happens before the pipeline
runs: `"auto"` (the default) reads the persistent tuning table
(`repro_torch.tune`): the digest-keyed artifact plan first, then the
per-pattern tuned entries, else the kernels' default plans on a cold
table. The result is a concrete `TilePlan` whose content key the
program cache keys on: two tile configs of one digest are two entries,
and a cold table resolves to the empty plan, whose key equals
`tiles="default"`'s. The emit pass hands each site's `TileConfig` to its
kernel wrapper, which maps it to its own knobs (the `*_knobs` functions
of `kernels/`).

A fault plan (`fault=`, a `guard.chaos.FaultPlan`) wraps the emitted
callable of every program it matches, so that program's outputs come
back corrupted (a `guard.fault.armed` event). A faulted compile never
reads or fills the program cache, and `lower_loop` forwards the plan to
every stage program of the loop.

`lower_loop()` lowers a LoopSpec: it compiles every stage program
through the cache and performs the cross-stage def-use and kind
inference that makes "scalar fed to a window port" or "value used
before it is produced" a spec error instead of a runtime surprise, with
the reference's SpecError codes and paths. That covers program, let and
cond stages, stack state with its `read` and `store` stages, and
nested `iterate` loops (GMRES's restarts).

"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Callable, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.kernels.common import resolve_device
from repro_torch.tune import config as tile_config
from repro_torch.tune import store as tune_store

from . import codegen, fusion, spec as spec_mod
from .graph import (DataflowGraph, ProgramIO, check_port_kinds,
                    collect_io, topo_sort)
from .spec import (CondStage, CountRule, InnerLoopStage, LetStage,
                   LoopSpec, ProgramStage, ReadStage, SpecError,
                   StoreStage, spec_error)

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
    # resolved tile configs (tune.TilePlan); the empty plan means "the
    # kernels' default plans everywhere"
    tile_plan: tile_config.TilePlan = tile_config.EMPTY_PLAN
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
    """Collect per-public-input placement hints (mesh-dimension names);
    `core.placement` turns them into shard specs on a device mesh."""
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
    ir.fn = codegen.emit_program(ir.graph, ir.groups, ir.mode,
                                 tiles=ir.tile_plan)


PIPELINE: Tuple = (
    ("parse", parse_pass),
    ("graph", graph_pass),
    ("infer", infer_pass),
    ("fuse", fuse_pass),
    ("place", place_pass),
    ("emit", emit_pass),
)


def _canonical_raw(raw: Union[str, Mapping, pathlib.Path]) -> Mapping:
    if hasattr(raw, "to_spec") and not isinstance(raw, Mapping):
        # builder protocol (blas.ProgramBuilder): anything that can
        # serialize itself to a raw spec dict lowers and digests exactly
        # like that dict
        raw = raw.to_spec()
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


def _device_kind(device) -> str:
    """The tuning table's device key of a compile: "cpu" for the plain
    versions, else the card's (`tune.current_device_kind`)."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    return tile_config.current_device_kind()


# memo of "auto" resolutions: (digest, mode, fuse, anchor, device kind,
# store generation) -> TilePlan. Keyed on the store generation, so a
# tune (or an artifact write) invalidates exactly the resolutions it
# affects and a repeated compile stays a dict lookup.
_RESOLVE_CACHE: dict = {}


def resolve_tiles(raw, *, mode: str = "dataflow",
                  fuse: Optional[bool] = None,
                  anchor: Optional[bool] = None, tiles="auto",
                  digest: Optional[str] = None,
                  device=None) -> tile_config.TilePlan:
    """The concrete TilePlan a `tiles=` request lowers with.
    `"default"`/None -> the empty plan (the kernels' default plans); a
    TileConfig applies everywhere; a TilePlan is taken as it is;
    `"auto"` reads the persistent table for `device`'s kind: the
    digest-keyed artifact plan where there is one (a `tune.cache.hit`
    counter), else the per-pattern tuned entries that a partial
    lowering (parse -> fuse, no codegen) finds for the program's sites.
    A cold table resolves to the empty plan: a compile never sweeps."""
    if isinstance(tiles, tile_config.TilePlan):
        return tiles
    if isinstance(tiles, tile_config.TileConfig):
        return tile_config.TilePlan.everywhere(tiles)
    if tiles in (None, "default"):
        return tile_config.EMPTY_PLAN
    if tiles != "auto":
        raise ValueError(
            f"tiles must be 'auto', 'default', a TileConfig, or a "
            f"TilePlan; got {tiles!r}")
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    raw = _canonical_raw(raw)
    if digest is None:
        digest = spec_digest(raw)
    store = tune_store.get_store()
    dk = _device_kind(device)
    key = (digest, mode, fuse, anchor, dk, store.generation)
    hit = _RESOLVE_CACHE.get(key)
    if hit is not None:
        return hit
    plan = store.artifact_plan(digest, mode, fuse, anchor, dk)
    if plan is None:
        probe = lower(raw, mode=mode, fuse=fuse, anchor=anchor,
                      upto="fuse", tiles="default", verify=False)
        sites = {}
        for gi, g in enumerate(probe.groups or ()):
            if g.fused and len(g.nodes) >= 2:
                pattern = "+".join(probe.graph.nodes[n].blas
                                   for n in g.nodes)
                buckets = store.entries_for(pattern, mode, fuse, anchor,
                                            dk)
                if buckets:
                    sites[f"g{gi}"] = buckets
                continue
            for name in g.nodes:
                buckets = store.entries_for(
                    probe.graph.nodes[name].blas, mode, fuse, anchor, dk)
                if buckets:
                    sites[f"g{gi}:{name}"] = buckets
        plan = tile_config.TilePlan.from_dict(sites)
    _RESOLVE_CACHE[key] = plan
    return plan


def lower(raw, *, mode: str = "dataflow", fuse: Optional[bool] = None,
          anchor: Optional[bool] = None, upto: Optional[str] = None,
          device=None, tiles="auto", verify: bool = True,
          fault=None) -> ProgramIR:
    """Run the pass pipeline over a raw spec. `upto` stops after the
    named pass (inclusive) for partial lowering in tests/tools.
    `anchor` gates level-2 anchored fusion groups (default: follows
    `fuse`, so dataflow mode gets them and nodataflow does not).
    `device` (default: the CUDA card) is resolved by the emit pass.
    `tiles` picks the kernels' plans: `"auto"` (the default) resolves
    from the persistent tuning table, `"default"` keeps the kernels'
    default plans, a TileConfig or TilePlan overrides them
    (`resolve_tiles`). `verify=True` (the default) runs the static
    analyzer first, so a malformed spec fails with one `VerifyError`;
    `verify=False` raises at the first site. `fault` (a
    `guard.chaos.FaultPlan`) wraps the emitted callable when it matches
    the program's name."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    raw = _canonical_raw(raw)
    if verify:
        from repro_torch import verify as verify_mod

        verify_mod.check(raw, mode=mode)
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    if anchor and not fuse:
        raise ValueError(
            "anchor=True requires fuse=True: level-2 anchored groups "
            "are a tier of the fusion planner, not a standalone pass")
    plan = resolve_tiles(raw, mode=mode, fuse=fuse, anchor=anchor,
                         tiles=tiles, device=device)
    ir = ProgramIR(raw=raw, digest=spec_digest(raw), mode=mode,
                   fuse=fuse, anchor=anchor, device=device,
                   tile_plan=plan)
    known = [name for name, _ in PIPELINE]
    if upto is not None and upto not in known:
        raise ValueError(f"unknown pass {upto!r}; pipeline: {known}")
    for name, p in PIPELINE:
        with obs.span(f"lowering.{name}", digest=ir.digest[:12],
                      mode=mode):
            p(ir)
        ir.passes_run.append(name)
        if name == upto:
            break
    # a partial lower (upto=...) is a probe, not a completed lowering,
    # so no "done" event
    if obs.enabled() and upto is None:
        obs.event("lowering.done",
                  program=ir.spec.name if ir.spec else None,
                  digest=ir.digest[:12], mode=mode, fuse=fuse,
                  anchor=anchor, passes=list(ir.passes_run))
    if fault is not None and ir.fn is not None and ir.spec is not None \
            and fault.matches(ir.spec.name):
        from repro_torch.guard import chaos

        ir.fn = chaos.wrap_program_fn(ir.fn, fault)
        obs.event("guard.fault.armed", program=ir.spec.name,
                  kind=fault.kind, output=fault.output,
                  iteration=fault.iteration)
    return ir


# ---------------------------------------------------------------------------
# Program cache
# ---------------------------------------------------------------------------

_CACHE: dict = {}
_STATS = {"hits": 0, "misses": 0}


def compile_cached(raw, *, mode: str = "dataflow",
                   fuse: Optional[bool] = None,
                   anchor: Optional[bool] = None, device=None,
                   tiles="auto", verify: bool = True,
                   fault=None) -> ProgramIR:
    """Fully lower a spec, memoized by (digest, mode, fuse, anchor,
    device, resolved tile-plan key). Loop programs reuse body specs, and
    the cache makes each distinct body compile once per configuration.
    The analyzer runs before the cache lookup and before the tile
    probe, so a broken spec fails with one `VerifyError`, never the
    probe's first raise. A program that `fault` matches compiles fresh
    with the corruption installed, and neither reads nor fills the
    cache."""
    raw = _canonical_raw(raw)
    if verify:
        from repro_torch import verify as verify_mod

        verify_mod.check(raw, mode=mode)
    if fuse is None:
        fuse = mode == "dataflow"
    if anchor is None:
        anchor = fuse
    device = resolve_device(device)
    digest = spec_digest(raw)
    plan = resolve_tiles(raw, mode=mode, fuse=fuse, anchor=anchor,
                         tiles=tiles, digest=digest, device=device)
    if fault is not None and fault.matches(raw.get("name")):
        return lower(raw, mode=mode, fuse=fuse, anchor=anchor,
                     device=device, tiles=plan, verify=False, fault=fault)
    key = (digest, mode, fuse, anchor, str(device), plan.key())
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        obs.counter("lowering.cache.hit", digest=key[0][:12], mode=mode)
        return hit
    _STATS["misses"] += 1
    obs.counter("lowering.cache.miss", digest=key[0][:12], mode=mode)
    ir = lower(raw, mode=mode, fuse=fuse, anchor=anchor, device=device,
               tiles=plan, verify=False)
    _CACHE[key] = ir
    return ir


def cache_stats() -> Mapping[str, int]:
    """Program-cache hit/miss/size counters. The same hits and misses
    are published as `lowering.cache.hit` / `lowering.cache.miss` obs
    counters while recording is on."""
    return dict(_STATS, size=len(_CACHE))


def clear_cache() -> None:
    _CACHE.clear()
    _RESOLVE_CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


# ---------------------------------------------------------------------------
# Loop lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompiledStage:
    """One lowered loop stage, tagged by kind:

    - ``program`` — `inputs`/`outputs` are fully-resolved maps between
      the inner program's public names and loop-environment names
      (identity defaults applied), `ir` the compiled program;
    - ``cond`` — `then`/`orelse` are compiled branch stage tuples and
      `produced` the (sorted) names both branches define, which are
      the only names surviving past the cond;
    - ``loop`` — a nested iterate; `body` is the compiled inner stage
      tuple (state/stop/yields live on the InnerLoopStage itself);
    - ``let`` / ``read`` / ``store`` — the parsed stage carries
      everything.

    `copy` names the values this stage binds that would otherwise
    alias a live stack (one a running loop may still store into): a
    read of a slot, a bare-name let or a nested loop's state init. The
    driver binds a copy of each, so a later store leaves them as they
    were, as `jax.numpy`'s value semantics do. `feedback_copy` (loop
    stages) names the inner state fields fed back from a live stack.
    """
    stage: object
    tag: str
    ir: Optional[ProgramIR] = None       # program stages only
    inputs: Optional[Mapping] = None     # program input -> env name
    outputs: Optional[Mapping] = None    # program output -> env name
    then: Optional[Tuple] = None         # cond branches
    orelse: Optional[Tuple] = None
    produced: Optional[Tuple] = None     # cond: branch-common names
    body: Optional[Tuple] = None         # inner loop compiled body
    copy: frozenset = frozenset()
    feedback_copy: frozenset = frozenset()


@dataclasses.dataclass(frozen=True)
class LoopIR:
    """A lowered loop program, executable by solvers.LoopProgram.
    `feedback_copy` names the state fields fed back from a stack of the
    loop (copied, as a loop stage's `feedback_copy`)."""
    lspec: LoopSpec
    mode: str
    device: torch.device
    setup: Tuple          # (CompiledStage, ...)
    body: Tuple
    setup_kinds: Mapping[str, str]   # env after setup: name -> kind
    state_kinds: Mapping[str, str]
    body_kinds: Mapping[str, str]    # env after one body iteration
    feedback_copy: frozenset = frozenset()


def _no_forward_ref(name, kinds, where, sink=None) -> bool:
    """True when `name` is in scope; raises (or records RV201 on the
    sink and returns False) otherwise."""
    if name not in kinds:
        spec_error(
            sink,
            f"{where}: {name!r} is not defined at this point in the "
            f"loop (operands, state, and values produced by earlier "
            f"stages are in scope); values from later stages cannot be "
            f"used — cyclic feedback must be routed through "
            f"iterate.state",
            code="RV201", path=where,
            hint="produce the value in an earlier stage, or route the "
                 "cycle through iterate.state")
        return False
    return True


def _stack_kind(of: str) -> str:
    return f"{of}-stack"


# what a read along the leading axis of each env-value kind yields
_READ_KINDS = {
    "matrix-stack": "matrix",
    "vector-stack": "vector",
    "scalar-stack": "scalar",
    "matrix": "vector",
    "vector": "scalar",
}

# the poisoned kind sink-mode analysis assigns after an error, so one
# mistake does not cascade into kind errors on every downstream use.
# It never appears when sink is None (the first error raises).
_UNKNOWN = "unknown"


def _check_scalar_expr(expr, kinds, where, sink=None) -> bool:
    ok = True
    for n in sorted(expr.names):
        if not _no_forward_ref(n, kinds, where, sink):
            ok = False
            continue
        if kinds[n] not in ("scalar", _UNKNOWN):
            spec_error(
                sink,
                f"{where}: expression {expr.src!r} uses {n!r} which "
                f"is a {kinds[n]}, not a scalar",
                code="RV208", path=where,
                hint="scalar expressions may only reference scalars; "
                     "reduce vectors with a routine (dot/nrm2) first")
            ok = False
    return ok


def _bind_single(name, kinds, produced, where, sink=None) -> None:
    if name in kinds:
        spec_error(
            sink,
            f"{where}: binding {name!r} rebinds an existing name "
            f"(loop values are single-assignment per iteration; only "
            f"stacks mutate, via store)",
            code="RV202", path=where,
            hint="pick a fresh name; loop values are "
                 "single-assignment per iteration")
    produced.add(name)


def _check_stack_field(f, env_kinds, where, sink=None) -> None:
    """A stack field's slot0/like/from references: matrix mismatches
    fire RV504, the others RV208, as in the reference."""
    if f.slot0 is not None and _no_forward_ref(
            f.slot0, env_kinds, f"{where}.init.slot0", sink):
        if env_kinds[f.slot0] not in (f.of, _UNKNOWN):
            matrixy = f.of == "matrix" or env_kinds[f.slot0] == "matrix"
            spec_error(
                sink,
                f"{where}.init.slot0: {f.slot0!r} is a "
                f"{env_kinds[f.slot0]}, but the stack holds "
                f"{f.of} slots",
                code="RV504" if matrixy else "RV208",
                path=f"{where}.init.slot0")
    if f.like is not None and _no_forward_ref(
            f.like, env_kinds, f"{where}.like", sink):
        want_like = "matrix" if f.of == "matrix" else "vector"
        if env_kinds[f.like] not in (want_like, _UNKNOWN):
            matrixy = f.of == "matrix" or env_kinds[f.like] == "matrix"
            spec_error(
                sink,
                f"{where}.like: {f.like!r} is a {env_kinds[f.like]}; "
                f"the element-shape prototype of a {f.of} stack must "
                f"be a {want_like}",
                code="RV504" if matrixy else "RV208",
                path=f"{where}.like")
    if f.source is not None and _no_forward_ref(
            f.source, env_kinds, f"{where}.init.from", sink):
        want = {"vector": ("matrix", "vector-stack"),
                "matrix": ("matrix-stack",)}.get(
                    f.of, ("vector", "scalar-stack"))
        if env_kinds[f.source] not in want + (_UNKNOWN,):
            matrixy = f.of == "matrix" or \
                env_kinds[f.source] in ("matrix", "matrix-stack")
            spec_error(
                sink,
                f"{where}.init.from: {f.source!r} is a "
                f"{env_kinds[f.source]}; a {f.of} stack adopts a "
                f"{' or '.join(want)} buffer",
                code="RV504" if matrixy else "RV208",
                path=f"{where}.init.from")


def _state_kinds(state_fields, env_kinds, where_prefix, sink=None):
    """Infer/check the kind of every state field against the
    environment its inits are evaluated in. Bare-name inits inherit
    the referenced kind; composite expressions are scalar arithmetic;
    stack fields check their slot0/like/from references."""
    out = {}
    for f in state_fields:
        where = f"{where_prefix}.{f.name}"
        if f.is_stack:
            _check_stack_field(f, env_kinds, where, sink)
            out[f.name] = _stack_kind(f.of)
            continue
        bare = f.init.bare_name
        if bare is not None:
            if _no_forward_ref(bare, env_kinds, where, sink):
                inferred = env_kinds[bare]
            else:
                inferred = _UNKNOWN
        else:
            _check_scalar_expr(f.init, env_kinds, where, sink)
            inferred = "scalar"
        if f.kind is not None and f.kind != inferred \
                and inferred != _UNKNOWN:
            spec_error(
                sink,
                f"{where}: declared kind {f.kind!r} but init "
                f"{f.init.src!r} is a {inferred}",
                code="RV208", path=where)
        out[f.name] = inferred
    return out


def _aliases(fields, live) -> frozenset:
    """Non-stack state fields whose bare-name init names a live stack."""
    return frozenset(f.name for f in fields if not f.is_stack
                     and f.init.bare_name in live)


def _feedback_aliases(feedback, live) -> frozenset:
    return frozenset(f for f, src in feedback.items() if src in live)


def _probe_stage(st, where, kinds, produced, mode, sink):
    """The analyzer's view of a program stage: parse -> graph -> infer
    only (no codegen, nothing built or launched); the inner spec's
    findings land at the stage's path. Returns the probe IR, or None
    after recording the inner error (the stage's outputs then carry the
    kind "unknown")."""
    try:
        return lower(st.raw_program, mode=mode, upto="infer",
                     tiles="default", verify=False)
    except SpecError as e:
        inner_path = f"{where}.program" + (
            f".{e.path}" if getattr(e, "path", None) else "")
        sink.error(f"{where}.program: {e}",
                   code=getattr(e, "code", None) or "RV100",
                   path=inner_path, hint=getattr(e, "hint", None))
        for env_name in st.outputs.values():
            if isinstance(env_name, str) and \
                    spec_mod._IDENT.match(env_name):
                kinds[env_name] = _UNKNOWN
                produced.add(env_name)
        return None


def _lower_stages(stages, kinds, where_prefix, *, mode, device,
                  tiles="auto", stacks=frozenset(), live=frozenset(),
                  in_cond=False, sink=None, fault=None):
    """Lower a stage list against an env of name -> kind, enforcing
    single-assignment, no forward references, and port-kind typing.
    `stacks` names the innermost enclosing loop's stack state fields
    (the only legal store targets), `live` the stacks of every
    enclosing loop. `tiles` and `fault` are forwarded to every stage
    program's compile. Mutates `kinds`; returns (compiled stages,
    produced names).

    With `sink` set (the static analyzer, `repro_torch.verify`) every
    violation is recorded instead of raised, stage programs are probed
    with a partial lowering (no codegen), and names whose kind an
    earlier error obscured carry the poisoned kind "unknown" so one
    mistake does not cascade."""
    compiled, produced = [], set()
    for i, st in enumerate(stages):
        where = f"{where_prefix}[{i}]"
        if isinstance(st, LetStage):
            copy = set()
            for name, expr in st.bindings:
                bare = expr.bare_name
                if bare is not None:
                    # a bare-name let aliases a value of ANY kind — the
                    # spec-level way for a cond branch to pass a vector
                    # through unchanged
                    if _no_forward_ref(bare, kinds, f"{where}.{name}",
                                       sink):
                        kind = kinds[bare]
                    else:
                        kind = _UNKNOWN
                    if bare in live:
                        copy.add(name)
                else:
                    _check_scalar_expr(expr, kinds, f"{where}.{name}",
                                       sink)
                    kind = "scalar"
                _bind_single(name, kinds, produced, where, sink)
                kinds[name] = kind
            compiled.append(CompiledStage(stage=st, tag="let",
                                          copy=frozenset(copy)))
            continue

        if isinstance(st, ReadStage):
            if _no_forward_ref(st.source, kinds, f"{where}.read.from",
                               sink):
                src_kind = kinds[st.source]
            else:
                src_kind = _UNKNOWN
            if src_kind not in _READ_KINDS and src_kind != _UNKNOWN:
                spec_error(
                    sink,
                    f"{where}.read.from: {st.source!r} is a "
                    f"{src_kind}; reads slice stacks, matrices "
                    f"(rows), and vectors (elements) along their "
                    f"leading axis",
                    code="RV208", path=f"{where}.read.from")
                src_kind = _UNKNOWN
            _check_scalar_expr(st.slot, kinds, f"{where}.read.slot", sink)
            _bind_single(st.name, kinds, produced, f"{where}.read.name",
                         sink)
            kinds[st.name] = _READ_KINDS.get(src_kind, _UNKNOWN)
            compiled.append(CompiledStage(
                stage=st, tag="read",
                copy=frozenset([st.name] if st.source in live else [])))
            continue

        if isinstance(st, StoreStage):
            if in_cond:
                spec_error(
                    sink,
                    f"{where}.store: stores are not allowed inside "
                    f"cond branches (branches are value-level; route "
                    f"the value out and store unconditionally)",
                    code="RV210", path=f"{where}.store",
                    hint="compute the value in the branch, then store "
                         "it after the cond")
            if st.into not in stacks:
                spec_error(
                    sink,
                    f"{where}.store.into: {st.into!r} is not a stack "
                    f"state field of the enclosing loop (stores "
                    f"mutate the loop's own stacks; declared stacks: "
                    f"{sorted(stacks)})",
                    code="RV208", path=f"{where}.store.into",
                    hint=f"declared stacks: {sorted(stacks)}")
                elem = into_kind = _UNKNOWN
            else:
                into_kind = kinds[st.into]
                elem = _READ_KINDS[into_kind]
            _check_scalar_expr(st.slot, kinds, f"{where}.store.slot",
                               sink)
            if _no_forward_ref(st.value, kinds, f"{where}.store.value",
                               sink):
                vkind = kinds[st.value]
            else:
                vkind = _UNKNOWN
            if st.at is not None:
                if into_kind not in ("vector-stack", _UNKNOWN):
                    spec_error(
                        sink,
                        f"{where}.store.at: element stores need a "
                        f"vector stack, {st.into!r} is a {into_kind}",
                        code="RV208", path=f"{where}.store.at")
                _check_scalar_expr(st.at, kinds, f"{where}.store.at",
                                   sink)
                if vkind not in ("scalar", _UNKNOWN):
                    spec_error(
                        sink,
                        f"{where}.store.value: an element store writes "
                        f"a scalar, {st.value!r} is a {vkind}",
                        code="RV208", path=f"{where}.store.value")
            elif vkind != elem and _UNKNOWN not in (vkind, elem):
                spec_error(
                    sink,
                    f"{where}.store.value: {st.value!r} is a {vkind}, "
                    f"but {st.into!r} holds {elem} slots",
                    code="RV208", path=f"{where}.store.value")
            compiled.append(CompiledStage(stage=st, tag="store"))
            continue

        if isinstance(st, CondStage):
            _check_scalar_expr(st.pred, kinds, f"{where}.cond.if", sink)
            branch_out = []
            for label, sub in (("then", st.then), ("else", st.orelse)):
                bkinds = dict(kinds)
                bcomp, bprod = _lower_stages(
                    sub, bkinds, f"{where}.cond.{label}", mode=mode,
                    device=device, tiles=tiles, live=live, in_cond=True,
                    sink=sink, fault=fault)
                branch_out.append((bcomp, bprod, bkinds))
            (then_c, then_p, then_k), (else_c, else_p, else_k) = \
                branch_out
            common = sorted(then_p & else_p)
            if not common:
                spec_error(
                    sink,
                    f"{where}.cond: no name is produced by BOTH "
                    f"branches (then: {sorted(then_p)}, else: "
                    f"{sorted(else_p)}); only branch-common names "
                    f"survive a cond, so this cond can have no "
                    f"effect",
                    code="RV210", path=f"{where}.cond",
                    hint="produce the surviving value under the same "
                         "name in both branches")
            for n in common:
                if then_k[n] != else_k[n] \
                        and _UNKNOWN not in (then_k[n], else_k[n]):
                    spec_error(
                        sink,
                        f"{where}.cond: {n!r} is a {then_k[n]} in "
                        f"'then' but a {else_k[n]} in 'else'; a name "
                        f"surviving the cond must have one kind",
                        code="RV208", path=f"{where}.cond")
                kinds[n] = then_k[n]
                produced.add(n)
            compiled.append(CompiledStage(
                stage=st, tag="cond", then=tuple(then_c),
                orelse=tuple(else_c), produced=tuple(common)))
            continue

        if isinstance(st, InnerLoopStage):
            compiled.append(_lower_inner_loop(
                st, kinds, produced, where, mode=mode, device=device,
                tiles=tiles, live=live, in_cond=in_cond, sink=sink,
                fault=fault))
            continue

        assert isinstance(st, ProgramStage)
        if sink is None:
            ir = compile_cached(st.raw_program, mode=mode, device=device,
                                tiles=tiles, verify=False, fault=fault)
        else:
            ir = _probe_stage(st, where, kinds, produced, mode, sink)
            if ir is None:
                compiled.append(CompiledStage(
                    stage=st, tag="program", ir=None,
                    inputs=dict(st.inputs), outputs=dict(st.outputs)))
                continue
        unknown = set(st.inputs) - set(ir.io.input_kinds)
        if unknown:
            spec_error(
                sink,
                f"{where}: input bindings for unknown program inputs "
                f"{sorted(unknown)}; program {ir.spec.name!r} takes "
                f"{sorted(ir.io.input_kinds)}",
                code="RV211", path=where,
                hint=f"program {ir.spec.name!r} takes "
                     f"{sorted(ir.io.input_kinds)}")
        unknown = set(st.outputs) - set(ir.io.output_kinds)
        if unknown:
            spec_error(
                sink,
                f"{where}: output bindings for unknown program outputs "
                f"{sorted(unknown)}; program {ir.spec.name!r} produces "
                f"{sorted(ir.io.output_kinds)}",
                code="RV211", path=where,
                hint=f"program {ir.spec.name!r} produces "
                     f"{sorted(ir.io.output_kinds)}")

        in_bind = {}
        for pub, kind in ir.io.input_kinds.items():
            env_name = st.inputs.get(pub, pub)
            if not _no_forward_ref(env_name, kinds,
                                   f"{where} input {pub!r}", sink):
                continue
            have = kinds[env_name]
            # a stack buffer is directly usable one level up: a stack
            # of vectors is a (slots, n) matrix window, a stack of
            # scalars is a (slots,) vector — how GMRES feeds its
            # Krylov basis to gemv
            stack_ok = (kind == "matrix" and have == "vector-stack") \
                or (kind == "vector" and have == "scalar-stack")
            if have != kind and not stack_ok and have != _UNKNOWN:
                if kind in ("vector", "matrix") and have == "scalar":
                    spec_error(
                        sink,
                        f"{where}: scalar value {env_name!r} cannot "
                        f"feed window port {pub!r} of program "
                        f"{ir.spec.name!r} (scalars travel on streams, "
                        f"windows carry {kind}s)",
                        code="RV208", path=where,
                        hint="feed the port a vector/matrix value; "
                             "scalars bind to scalar input streams")
                else:
                    spec_error(
                        sink,
                        f"{where}: {env_name!r} is a {have} but "
                        f"program input {pub!r} wants a {kind}",
                        code="RV208", path=where)
            in_bind[pub] = env_name

        out_bind = {}
        for pub, kind in ir.io.output_kinds.items():
            env_name = st.outputs.get(pub, pub)
            if not spec_mod._IDENT.match(env_name):
                spec_error(
                    sink,
                    f"{where}: program output {pub!r} needs an "
                    f"identifier environment name (alias it in the "
                    f"stage's 'outputs' or the inner spec), got "
                    f"{env_name!r}",
                    code="RV211", path=where)
                continue
            if env_name in kinds:
                spec_error(
                    sink,
                    f"{where}: output {pub!r} -> {env_name!r} rebinds "
                    f"an existing name (loop values are "
                    f"single-assignment per iteration)",
                    code="RV202", path=where)
            kinds[env_name] = kind
            out_bind[pub] = env_name
            produced.add(env_name)

        compiled.append(CompiledStage(stage=st, tag="program", ir=ir,
                                      inputs=in_bind, outputs=out_bind))
    return tuple(compiled), produced


def _lower_inner_loop(st: InnerLoopStage, kinds, produced, where, *,
                      mode, device, live, in_cond, tiles="auto",
                      sink=None, fault=None) -> CompiledStage:
    """Lower a nested iterate: inner state inits read the enclosing
    environment, the inner body is lowered against enclosing env +
    inner state (+ counter), and yields bind final inner state into
    the enclosing environment."""
    if in_cond:
        spec_error(
            sink,
            f"{where}.iterate: nested loops are not allowed inside "
            f"cond branches (branches are value-level)",
            code="RV210", path=f"{where}.iterate",
            hint="hoist the inner loop out of the cond branch")
    inner_kinds = dict(kinds)
    if st.counter is not None:
        if st.counter in inner_kinds:
            spec_error(
                sink,
                f"{where}.iterate.counter: {st.counter!r} rebinds an "
                f"existing name",
                code="RV202", path=f"{where}.iterate.counter")
        inner_kinds[st.counter] = "scalar"

    skinds = _state_kinds(st.state, kinds, f"{where}.iterate.state", sink)
    for f in st.state:
        if f.name in inner_kinds:
            spec_error(
                sink,
                f"{where}.iterate.state.{f.name}: shadows an "
                f"enclosing value (pick a fresh name; enclosing "
                f"values stay readable inside the inner body)",
                code="RV202", path=f"{where}.iterate.state.{f.name}",
                hint="pick a fresh name; enclosing values stay "
                     "readable inside the inner body")
    inner_kinds.update(skinds)

    inner_stacks = frozenset(f.name for f in st.state if f.is_stack)
    inner_live = live | inner_stacks
    body, inner_produced = _lower_stages(
        st.body, inner_kinds, f"{where}.iterate.body", mode=mode,
        device=device, tiles=tiles, stacks=inner_stacks, live=inner_live,
        sink=sink, fault=fault)

    for fname, src in st.feedback.items():
        fwhere = f"{where}.iterate.feedback.{fname}"
        if not _no_forward_ref(src, inner_kinds, fwhere, sink):
            continue
        if inner_kinds[src] != skinds[fname] \
                and _UNKNOWN not in (inner_kinds[src], skinds[fname]):
            matrixy = "matrix" in (inner_kinds[src], skinds[fname])
            spec_error(
                sink,
                f"{fwhere}: cannot feed a {inner_kinds[src]} back "
                f"into {skinds[fname]} state field {fname!r}",
                code="RV504" if matrixy else "RV208", path=fwhere)

    stop = st.stop
    if isinstance(stop, CountRule):
        # the trip count is fixed at loop entry: enclosing scope only
        _check_scalar_expr(stop.count, kinds,
                           f"{where}.iterate.while.count", sink)
    else:
        _check_stop(stop, inner_produced, inner_kinds, kinds,
                    f"{where}.iterate.while", "the inner loop body", sink)

    for outer_name, field in st.yields.items():
        _bind_single(outer_name, kinds, produced,
                     f"{where}.iterate.yield.{outer_name}", sink)
        kinds[outer_name] = skinds.get(field, _UNKNOWN)
    return CompiledStage(
        stage=st, tag="loop", body=body, copy=_aliases(st.state, live),
        feedback_copy=_feedback_aliases(st.feedback, inner_live))


def _check_scalar_name(name, kinds, where, sink=None) -> None:
    """RV209 unless `name` is a scalar of `kinds` (or of unknown kind
    after an earlier recorded error)."""
    if _no_forward_ref(name, kinds, where, sink) \
            and kinds[name] not in ("scalar", _UNKNOWN):
        spec_error(
            sink,
            f"{where}: {name!r} is a {kinds[name]}, not a scalar",
            code="RV209", path=where)


def _check_stop(stop, produced, body_kinds, entry_kinds, swhere, body,
                sink=None) -> None:
    """A metric stop rule: the metric a scalar the body produces; its
    initial value and a named scale scalars of the loop's entry
    environment."""
    if stop.metric not in produced:
        spec_error(
            sink,
            f"{swhere}.metric: {stop.metric!r} is not produced by "
            f"{body}",
            code="RV209", path=f"{swhere}.metric",
            hint="the stop metric must be a scalar the body computes "
                 "each iteration")
    else:
        _check_scalar_name(stop.metric, body_kinds, f"{swhere}.metric",
                           sink)
    _check_scalar_name(stop.init_metric, entry_kinds, f"{swhere}.init",
                       sink)
    if isinstance(stop.scale, str):
        _check_scalar_name(stop.scale, entry_kinds, f"{swhere}.scale",
                           sink)


def lower_loop(raw, *, mode: str = "dataflow", device=None,
               tiles="auto", sink=None, verify: bool = True,
               fault=None) -> LoopIR:
    """Lower a loop spec: compile every stage program through the cache
    (on `device`, default the CUDA card) and type-check the loop
    environment end to end, with the reference's SpecError codes and
    paths. `tiles` is forwarded to every stage program's
    `compile_cached` call.

    `verify=True` (the default) runs the static analyzer
    (`repro_torch.verify`) over the raw spec first, so a malformed
    program fails with one `VerifyError` listing every finding before
    anything is compiled. `sink` is the analyzer's way in: with a sink
    set, violations are recorded instead of raised, stage programs are
    probed (parse, graph and infer only: nothing is built or launched)
    and verification is skipped (the sink IS the verifier).

    `fault` (a `guard.chaos.FaultPlan`) is forwarded to every stage
    program's compile: the programs it matches come back with their
    outputs corrupted, compiled apart from the clean program cache."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    if verify and sink is None and not isinstance(raw, LoopSpec):
        from repro_torch import verify as verify_mod

        verify_mod.check(raw, mode=mode)
    if sink is None:
        device = resolve_device(device)
    lspec = raw if isinstance(raw, LoopSpec) else spec_mod.parse_loop(raw)

    kinds = dict(lspec.operands)
    setup, _ = _lower_stages(lspec.setup, kinds, "setup", mode=mode,
                             device=device, tiles=tiles, sink=sink,
                             fault=fault)
    setup_kinds = dict(kinds)
    state_kinds = _state_kinds(lspec.state, setup_kinds, "iterate.state",
                               sink)

    body_env = dict(setup_kinds)
    body_env.update(state_kinds)
    # the driver binds the stop threshold (tol * scale) into the body
    # environment so cond predicates can express early exits like
    # BiCGStab's ‖s‖ test; the name is reserved
    if "threshold" in body_env:
        spec_error(
            sink,
            "'threshold' is a reserved loop-body name (the driver "
            "binds it to the stop threshold tol * scale); rename the "
            "conflicting operand/setup value/state field",
            code="RV207", path="iterate.state",
            hint="rename the conflicting operand/setup value/state "
                 "field")
    body_env["threshold"] = "scalar"
    stacks = frozenset(f.name for f in lspec.state if f.is_stack)
    body, produced = _lower_stages(lspec.body, body_env, "iterate.body",
                                   mode=mode, device=device, tiles=tiles,
                                   stacks=stacks, live=stacks, sink=sink,
                                   fault=fault)

    for fname, src in lspec.feedback.items():
        where = f"iterate.feedback.{fname}"
        if not _no_forward_ref(src, body_env, where, sink):
            continue
        want = state_kinds.get(fname, _UNKNOWN)
        if body_env[src] != want and _UNKNOWN not in (body_env[src], want):
            matrixy = "matrix" in (body_env[src], want)
            spec_error(
                sink,
                f"{where}: cannot feed a {body_env[src]} back into "
                f"{want} state field {fname!r}",
                code="RV504" if matrixy else "RV208", path=where)

    _check_stop(lspec.stop, produced, body_env, setup_kinds,
                "iterate.while", "the loop body", sink)
    if lspec.guards is not None:
        _check_guards(lspec.guards, body_env, produced, sink)

    return LoopIR(lspec=lspec, mode=mode, device=device, setup=setup,
                  body=body, setup_kinds=setup_kinds,
                  state_kinds=state_kinds, body_kinds=body_env,
                  feedback_copy=_feedback_aliases(lspec.feedback, stacks))


def _check_guards(guards, body_env, produced, sink=None) -> None:
    """Resolve `iterate.guards` names against the lowered body
    environment: nonfinite targets must be body-iteration values of
    any kind; breakdown sentinels must be body-produced scalars or
    vectors. Structural validation already happened in
    `spec._parse_guards` (RV500/RV503)."""
    for i, name in enumerate(guards.nonfinite):
        where = f"iterate.guards.nonfinite[{i}]"
        if name not in body_env:
            spec_error(
                sink,
                f"{where}: {name!r} is not in the loop-body "
                f"environment (guards watch operands, state, or "
                f"body-produced values)",
                code="RV501", path=where,
                hint="guard a name the body environment defines")
    for i, b in enumerate(guards.breakdown):
        where = f"iterate.guards.breakdown[{i}].value"
        if b.value not in produced:
            spec_error(
                sink,
                f"{where}: {b.value!r} is not produced by the loop "
                f"body (breakdown sentinels watch per-iteration "
                f"scalars like p'Ap or rho)",
                code="RV501", path=where,
                hint="watch a scalar the body computes each iteration")
        elif body_env[b.value] not in ("scalar", "vector", _UNKNOWN):
            spec_error(
                sink,
                f"{where}: {b.value!r} is a {body_env[b.value]}, "
                f"not a scalar or vector",
                code="RV502", path=where,
                hint="breakdown guards trip when any |entry| < below "
                     "(a vector gives one sentinel per right-hand side)")
