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

`lower_loop()` lowers a LoopSpec: it compiles every stage program
through the cache and performs the cross-stage def-use and kind
inference that makes "scalar fed to a window port" or "value used
before it is produced" a spec error instead of a runtime surprise, with
the reference's SpecError codes and paths.

Not ported yet: tuned tile plans (`tiles` resolves only to the kernel
defaults; the tuning store is ROADMAP Queue 1, item 12), the static
analyzer behind `verify=` (item 11), fault plans (`fault=`, item 10),
and the stack state, `read`/`store` stages and nested `iterate` loops
that only GMRES uses (item 8, slice 5): each raises NotImplementedError.
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
from .spec import (CondStage, InnerLoopStage, LetStage, LoopSpec,
                   ProgramStage, ReadStage, SpecError, StoreStage,
                   spec_error)

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


# ---------------------------------------------------------------------------
# Loop lowering
# ---------------------------------------------------------------------------

# the ROADMAP item that ports what only GMRES uses
_STACKS = "ROADMAP Queue 1, item 8 (slice 5: GMRES)"


@dataclasses.dataclass(frozen=True)
class CompiledStage:
    """One lowered loop stage, tagged by kind:

    - ``program`` — `inputs`/`outputs` are fully-resolved maps between
      the inner program's public names and loop-environment names
      (identity defaults applied), `ir` the compiled program;
    - ``cond`` — `then`/`orelse` are compiled branch stage tuples and
      `produced` the (sorted) names both branches define, which are
      the only names surviving past the cond;
    - ``let`` — the parsed stage carries everything.
    """
    stage: object
    tag: str
    ir: Optional[ProgramIR] = None       # program stages only
    inputs: Optional[Mapping] = None     # program input -> env name
    outputs: Optional[Mapping] = None    # program output -> env name
    then: Optional[Tuple] = None         # cond branches
    orelse: Optional[Tuple] = None
    produced: Optional[Tuple] = None     # cond: branch-common names


@dataclasses.dataclass(frozen=True)
class LoopIR:
    """A lowered loop program, executable by solvers.LoopProgram."""
    lspec: LoopSpec
    mode: str
    device: torch.device
    setup: Tuple          # (CompiledStage, ...)
    body: Tuple
    setup_kinds: Mapping[str, str]   # env after setup: name -> kind
    state_kinds: Mapping[str, str]
    body_kinds: Mapping[str, str]    # env after one body iteration


def _no_forward_ref(name, kinds, where) -> None:
    if name not in kinds:
        spec_error(
            None,
            f"{where}: {name!r} is not defined at this point in the "
            f"loop (operands, state, and values produced by earlier "
            f"stages are in scope); values from later stages cannot be "
            f"used — cyclic feedback must be routed through "
            f"iterate.state",
            code="RV201", path=where,
            hint="produce the value in an earlier stage, or route the "
                 "cycle through iterate.state")


def _refuse_stacks(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet ({_STACKS}); the port's loop driver "
        f"runs program, let and cond stages over matrix, vector and "
        f"scalar state")


def _check_scalar_expr(expr, kinds, where) -> None:
    for n in sorted(expr.names):
        _no_forward_ref(n, kinds, where)
        if kinds[n] != "scalar":
            spec_error(
                None,
                f"{where}: expression {expr.src!r} uses {n!r} which "
                f"is a {kinds[n]}, not a scalar",
                code="RV208", path=where,
                hint="scalar expressions may only reference scalars; "
                     "reduce vectors with a routine (dot/nrm2) first")


def _bind_single(name, kinds, produced, where) -> None:
    if name in kinds:
        spec_error(
            None,
            f"{where}: binding {name!r} rebinds an existing name "
            f"(loop values are single-assignment per iteration; only "
            f"stacks mutate, via store)",
            code="RV202", path=where,
            hint="pick a fresh name; loop values are "
                 "single-assignment per iteration")
    produced.add(name)


def _state_kinds(state_fields, env_kinds, where_prefix):
    """Infer/check the kind of every state field against the
    environment its inits are evaluated in. Bare-name inits inherit
    the referenced kind; composite expressions are scalar arithmetic.
    Stack fields are refused (slice 5)."""
    out = {}
    for f in state_fields:
        where = f"{where_prefix}.{f.name}"
        if f.is_stack:
            _refuse_stacks(f"stack state ({where})")
        bare = f.init.bare_name
        if bare is not None:
            _no_forward_ref(bare, env_kinds, where)
            inferred = env_kinds[bare]
        else:
            _check_scalar_expr(f.init, env_kinds, where)
            inferred = "scalar"
        if f.kind is not None and f.kind != inferred:
            spec_error(
                None,
                f"{where}: declared kind {f.kind!r} but init "
                f"{f.init.src!r} is a {inferred}",
                code="RV208", path=where)
        out[f.name] = inferred
    return out


def _lower_stages(stages, kinds, where_prefix, *, mode, device):
    """Lower a stage list against an env of name -> kind, enforcing
    single-assignment, no forward references, and port-kind typing.
    Mutates `kinds`; returns (compiled stages, produced names)."""
    compiled, produced = [], set()
    for i, st in enumerate(stages):
        where = f"{where_prefix}[{i}]"
        if isinstance(st, LetStage):
            for name, expr in st.bindings:
                bare = expr.bare_name
                if bare is not None:
                    # a bare-name let aliases a value of ANY kind — the
                    # spec-level way for a cond branch to pass a vector
                    # through unchanged
                    _no_forward_ref(bare, kinds, f"{where}.{name}")
                    kind = kinds[bare]
                else:
                    _check_scalar_expr(expr, kinds, f"{where}.{name}")
                    kind = "scalar"
                _bind_single(name, kinds, produced, where)
                kinds[name] = kind
            compiled.append(CompiledStage(stage=st, tag="let"))
            continue

        if isinstance(st, (ReadStage, StoreStage, InnerLoopStage)):
            kind = {ReadStage: "read", StoreStage: "store",
                    InnerLoopStage: "iterate"}[type(st)]
            _refuse_stacks(f"the {kind!r} stage ({where})")

        if isinstance(st, CondStage):
            _check_scalar_expr(st.pred, kinds, f"{where}.cond.if")
            branch_out = []
            for label, sub in (("then", st.then), ("else", st.orelse)):
                bkinds = dict(kinds)
                bcomp, bprod = _lower_stages(
                    sub, bkinds, f"{where}.cond.{label}", mode=mode,
                    device=device)
                branch_out.append((bcomp, bprod, bkinds))
            (then_c, then_p, then_k), (else_c, else_p, else_k) = \
                branch_out
            common = sorted(then_p & else_p)
            if not common:
                spec_error(
                    None,
                    f"{where}.cond: no name is produced by BOTH "
                    f"branches (then: {sorted(then_p)}, else: "
                    f"{sorted(else_p)}); only branch-common names "
                    f"survive a cond, so this cond can have no "
                    f"effect",
                    code="RV210", path=f"{where}.cond",
                    hint="produce the surviving value under the same "
                         "name in both branches")
            for n in common:
                if then_k[n] != else_k[n]:
                    spec_error(
                        None,
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

        assert isinstance(st, ProgramStage)
        ir = compile_cached(st.raw_program, mode=mode, device=device)
        unknown = set(st.inputs) - set(ir.io.input_kinds)
        if unknown:
            spec_error(
                None,
                f"{where}: input bindings for unknown program inputs "
                f"{sorted(unknown)}; program {ir.spec.name!r} takes "
                f"{sorted(ir.io.input_kinds)}",
                code="RV211", path=where,
                hint=f"program {ir.spec.name!r} takes "
                     f"{sorted(ir.io.input_kinds)}")
        unknown = set(st.outputs) - set(ir.io.output_kinds)
        if unknown:
            spec_error(
                None,
                f"{where}: output bindings for unknown program outputs "
                f"{sorted(unknown)}; program {ir.spec.name!r} produces "
                f"{sorted(ir.io.output_kinds)}",
                code="RV211", path=where,
                hint=f"program {ir.spec.name!r} produces "
                     f"{sorted(ir.io.output_kinds)}")

        in_bind = {}
        for pub, kind in ir.io.input_kinds.items():
            env_name = st.inputs.get(pub, pub)
            _no_forward_ref(env_name, kinds, f"{where} input {pub!r}")
            have = kinds[env_name]
            if have != kind:
                if kind in ("vector", "matrix") and have == "scalar":
                    spec_error(
                        None,
                        f"{where}: scalar value {env_name!r} cannot "
                        f"feed window port {pub!r} of program "
                        f"{ir.spec.name!r} (scalars travel on streams, "
                        f"windows carry {kind}s)",
                        code="RV208", path=where,
                        hint="feed the port a vector/matrix value; "
                             "scalars bind to scalar input streams")
                else:
                    spec_error(
                        None,
                        f"{where}: {env_name!r} is a {have} but "
                        f"program input {pub!r} wants a {kind}",
                        code="RV208", path=where)
            in_bind[pub] = env_name

        out_bind = {}
        for pub, kind in ir.io.output_kinds.items():
            env_name = st.outputs.get(pub, pub)
            if not spec_mod._IDENT.match(env_name):
                spec_error(
                    None,
                    f"{where}: program output {pub!r} needs an "
                    f"identifier environment name (alias it in the "
                    f"stage's 'outputs' or the inner spec), got "
                    f"{env_name!r}",
                    code="RV211", path=where)
            if env_name in kinds:
                spec_error(
                    None,
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


def _check_scalar_name(name, kinds, where) -> None:
    """RV209 unless `name` is a scalar of `kinds`."""
    _no_forward_ref(name, kinds, where)
    if kinds[name] != "scalar":
        spec_error(
            None,
            f"{where}: {name!r} is a {kinds[name]}, not a scalar",
            code="RV209", path=where)


def lower_loop(raw, *, mode: str = "dataflow", device=None,
               tiles="default", verify: bool = True,
               fault=None) -> LoopIR:
    """Lower a loop spec: compile every stage program through the cache
    (on `device`, default the CUDA card) and type-check the loop
    environment end to end, with the reference's SpecError codes and
    paths. `verify` is accepted for call-site compatibility with the
    reference; the static analyzer it runs there is ROADMAP Queue 1,
    item 11. `tiles` resolves only to the kernels' defaults (item 12),
    and a fault plan (`fault`) is item 10: both raise otherwise."""
    if mode not in ("dataflow", "nodataflow", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_tiles(tiles)
    if fault is not None:
        raise NotImplementedError(
            "fault plans (chaos testing) are not ported yet; they come "
            "with ROADMAP Queue 1, item 10")
    device = resolve_device(device)
    lspec = raw if isinstance(raw, LoopSpec) else spec_mod.parse_loop(raw)

    kinds = dict(lspec.operands)
    setup, _ = _lower_stages(lspec.setup, kinds, "setup", mode=mode,
                             device=device)
    setup_kinds = dict(kinds)
    state_kinds = _state_kinds(lspec.state, setup_kinds, "iterate.state")

    body_env = dict(setup_kinds)
    body_env.update(state_kinds)
    # the driver binds the stop threshold (tol * scale) into the body
    # environment so cond predicates can express early exits like
    # BiCGStab's ‖s‖ test; the name is reserved
    if "threshold" in body_env:
        spec_error(
            None,
            "'threshold' is a reserved loop-body name (the driver "
            "binds it to the stop threshold tol * scale); rename the "
            "conflicting operand/setup value/state field",
            code="RV207", path="iterate.state",
            hint="rename the conflicting operand/setup value/state "
                 "field")
    body_env["threshold"] = "scalar"
    body, produced = _lower_stages(lspec.body, body_env, "iterate.body",
                                   mode=mode, device=device)

    for fname, src in lspec.feedback.items():
        where = f"iterate.feedback.{fname}"
        _no_forward_ref(src, body_env, where)
        if body_env[src] != state_kinds[fname]:
            matrixy = "matrix" in (body_env[src], state_kinds[fname])
            spec_error(
                None,
                f"{where}: cannot feed a {body_env[src]} back into "
                f"{state_kinds[fname]} state field {fname!r}",
                code="RV504" if matrixy else "RV208", path=where)

    stop = lspec.stop
    if stop.metric not in produced:
        spec_error(
            None,
            f"iterate.while.metric: {stop.metric!r} is not produced by "
            f"the loop body",
            code="RV209", path="iterate.while.metric",
            hint="the stop metric must be a scalar the body computes "
                 "each iteration")
    _check_scalar_name(stop.metric, body_env, "iterate.while.metric")
    _check_scalar_name(stop.init_metric, setup_kinds, "iterate.while.init")
    if isinstance(stop.scale, str):
        _check_scalar_name(stop.scale, setup_kinds, "iterate.while.scale")
    if lspec.guards is not None:
        _check_guards(lspec.guards, body_env, produced)

    return LoopIR(lspec=lspec, mode=mode, device=device, setup=setup,
                  body=body, setup_kinds=setup_kinds,
                  state_kinds=state_kinds, body_kinds=body_env)


def _check_guards(guards, body_env, produced) -> None:
    """Resolve `iterate.guards` names against the lowered body
    environment: nonfinite targets must be body-iteration values of
    any kind; breakdown sentinels must be body-produced scalars or
    vectors. Structural validation already happened in
    `spec._parse_guards` (RV500/RV503)."""
    for i, name in enumerate(guards.nonfinite):
        where = f"iterate.guards.nonfinite[{i}]"
        if name not in body_env:
            spec_error(
                None,
                f"{where}: {name!r} is not in the loop-body "
                f"environment (guards watch operands, state, or "
                f"body-produced values)",
                code="RV501", path=where,
                hint="guard a name the body environment defines")
    for i, b in enumerate(guards.breakdown):
        where = f"iterate.guards.breakdown[{i}].value"
        if b.value not in produced:
            spec_error(
                None,
                f"{where}: {b.value!r} is not produced by the loop "
                f"body (breakdown sentinels watch per-iteration "
                f"scalars like p'Ap or rho)",
                code="RV501", path=where,
                hint="watch a scalar the body computes each iteration")
        elif body_env[b.value] not in ("scalar", "vector"):
            spec_error(
                None,
                f"{where}: {b.value!r} is a {body_env[b.value]}, "
                f"not a scalar or vector",
                code="RV502", path=where,
                hint="breakdown guards trip when any |entry| < below "
                     "(a vector gives one sentinel per right-hand side)")
