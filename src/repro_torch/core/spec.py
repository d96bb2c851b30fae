"""The JSON routine specification — the paper's user-facing interface.

A spec describes WHAT routines the user wants and HOW they connect;
the generator produces the design (Fig. 1). Faithful superset of the
AIEBLAS JSON schema:

```json
{
  "name": "axpydot",
  "dtype": "float32",
  "window_size": 256,            // default block rows (non-functional)
  "vector_width": 128,           // lane count (non-functional)
  "routines": [
    {
      "blas": "axpy",
      "name": "my_axpy",
      "scalars": {"alpha": {"input": "alpha"}},   // or {"value": -1.0}
      "connections": {"out": "my_dot.x"},         // on-chip edge; a list
                                                  // of targets fans out
                                                  // one window to many
                                                  // consumers
      "window_size": 512,                         // per-routine override
      "placement": {"x": ["data"], "y": ["data"]} // optional hint
    },
    {"blas": "dot", "name": "my_dot"}
  ]
}
```

Unconnected routine inputs become *program inputs* named
"<routine>.<port>" (aliasable via `"inputs": {"x": "w"}`); unconnected
outputs become program outputs. Scalars default to program inputs named
"<routine>.<scalar>".

A spec may instead describe a *loop program*: operands, setup stages,
and an `"iterate"` section with state fields, feedback edges (vectors
AND scalars), scalar update expressions, and a stop rule — see
`parse_loop` and docs/spec.md. `solvers.LoopProgram` runs them.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Mapping, Optional, Tuple, Union

import torch

from . import routines as R
from .expr import Expr, ExprError, parse_expr, parse_pred

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# The AIE window-size and vector-width knobs. They are parsed and
# validated exactly as in the reference so that every spec means the
# same thing in both packages; the port's kernels choose their own block
# sizes (kernels/common.py) and do not read them.
DEFAULT_WINDOW = 256      # block rows — the AIE window-size knob
DEFAULT_VECTOR_WIDTH = 128  # lanes — the AIE 512-bit vector-width knob


class SpecError(ValueError):
    """A spec-level validation error.

    Beyond the message, a SpecError may carry structured fields the
    static analyzer surfaces as typed diagnostics: a stable
    diagnostic `code` (e.g. "RV104"), a JSON `path` into the offending
    spec (e.g. "routines[1].connections.out"), and a one-line fix-it
    `hint`. Call sites that predate the analyzer may omit them; the
    analyzer falls back to a generic code and an empty path.
    """

    def __init__(self, message: str, *, code: Optional[str] = None,
                 path: Optional[str] = None,
                 hint: Optional[str] = None):
        super().__init__(message)
        self.code = code
        self.path = path
        self.hint = hint


def spec_error(sink, message, *, code=None, path=None, hint=None):
    """Raise a SpecError — or, when `sink` is not None, record the
    finding on it and return so validation can continue.

    This is the bridge between the enforcing path (lowering raises at
    the first error, exactly as before) and the static
    analyzer (which passes a diagnostics sink to collect *every*
    finding in one run). The sink is duck-typed: anything with an
    `.error(message, code=..., path=..., hint=...)` method works.
    """
    if sink is None:
        raise SpecError(message, code=code, path=path, hint=hint)
    sink.error(message, code=code, path=path, hint=hint)


@dataclasses.dataclass(frozen=True)
class ScalarBinding:
    """A routine scalar is either a literal or a program input stream."""
    kind: str                 # "value" | "input"
    value: Optional[float] = None
    input_name: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RoutineSpec:
    blas: str
    name: str
    scalars: Mapping[str, ScalarBinding]
    connections: Mapping[str, tuple]   # out port -> ("routine.port", ...)
    input_aliases: Mapping[str, str]   # in port  -> program input name
    output_aliases: Mapping[str, str]  # out port -> program output name
    window_size: int
    vector_width: int
    placement: Mapping[str, tuple]

    @property
    def rdef(self) -> R.RoutineDef:
        return R.get(self.blas)


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    name: str
    dtype: torch.dtype
    routines: tuple
    window_size: int
    vector_width: int

    def routine(self, name: str) -> RoutineSpec:
        for r in self.routines:
            if r.name == name:
                return r
        raise KeyError(name)


def _parse_scalar(name, raw, path=None) -> ScalarBinding:
    if isinstance(raw, (int, float)):
        return ScalarBinding("value", value=float(raw))
    if isinstance(raw, Mapping):
        if "value" in raw:
            return ScalarBinding("value", value=float(raw["value"]))
        if "input" in raw:
            return ScalarBinding("input", input_name=str(raw["input"]))
    raise SpecError(f"bad scalar binding for {name!r}: {raw!r}",
                    code="RV103", path=path,
                    hint="bind a scalar as a number, {'value': v}, or "
                         "{'input': name}")


def parse(spec: Union[str, Mapping, pathlib.Path]) -> ProgramSpec:
    """Parse and validate a JSON spec (dict, JSON string, or path)."""
    if isinstance(spec, pathlib.Path):
        spec = json.loads(spec.read_text())
    elif isinstance(spec, str):
        spec = json.loads(spec)
    if not isinstance(spec, Mapping):
        raise SpecError(f"spec must be a mapping, got {type(spec)}")

    name = spec.get("name", "program")
    dtype_name = spec.get("dtype", "float32")
    if dtype_name not in _DTYPES:
        raise SpecError(f"unsupported dtype {dtype_name!r}",
                        code="RV111", path="dtype",
                        hint=f"pick one of {sorted(_DTYPES)}")
    g_window = int(spec.get("window_size", DEFAULT_WINDOW))
    g_vw = int(spec.get("vector_width", DEFAULT_VECTOR_WIDTH))
    if g_vw % 128 != 0:
        raise SpecError(
            f"vector_width must be a multiple of 128 lanes (AIE vector width), "
            f"got {g_vw}",
            code="RV112", path="vector_width",
            hint="use 128, 256, 384, ... (whole vector registers)")

    raw_routines = spec.get("routines")
    if not raw_routines:
        raise SpecError("spec has no routines", code="RV100",
                        path="routines",
                        hint="add at least one routine entry")

    seen = set()
    parsed = []
    for ri, raw in enumerate(raw_routines):
        rpath = f"routines[{ri}]"
        blas = raw.get("blas")
        try:
            rdef = R.get(blas)
        except KeyError as e:
            # R.get raises a bare KeyError; surface it as a spec error
            # with the JSON path so the CLI/verify report can point at
            # the offending entry
            raise SpecError(str(e.args[0]) if e.args else
                            f"unknown BLAS routine {blas!r}",
                            code="RV101", path=f"{rpath}.blas",
                            hint=f"available routines: "
                                 f"{sorted(R.names())}") from None
        rname = raw.get("name", blas)
        if rname in seen:
            raise SpecError(f"duplicate routine name {rname!r}",
                            code="RV102", path=f"{rpath}.name",
                            hint="give each routine instance a unique "
                                 "'name'")
        seen.add(rname)

        scalars = {}
        raw_scalars = raw.get("scalars", {})
        for s in rdef.scalars:
            if s in raw_scalars:
                scalars[s] = _parse_scalar(s, raw_scalars[s],
                                           path=f"{rpath}.scalars.{s}")
            else:
                scalars[s] = ScalarBinding("input",
                                           input_name=f"{rname}.{s}")
        for s in raw_scalars:
            if s not in rdef.scalars:
                raise SpecError(
                    f"{rname}: routine {blas!r} has no scalar {s!r}",
                    code="RV103", path=f"{rpath}.scalars.{s}",
                    hint=f"{blas!r} scalars: {sorted(rdef.scalars)}")

        conns = {}
        for port, targets in dict(raw.get("connections", {})).items():
            if port not in rdef.outputs:
                raise SpecError(
                    f"{rname}: no output port {port!r} on {blas!r}",
                    code="RV103", path=f"{rpath}.connections.{port}",
                    hint=f"{blas!r} outputs: {sorted(rdef.outputs)}")
            if isinstance(targets, str):
                targets = (targets,)
            elif isinstance(targets, (list, tuple)):
                targets = tuple(targets)
            else:
                raise SpecError(
                    f"{rname}.{port}: connection target must be a "
                    f"'routine.port' string or a list of them, got "
                    f"{targets!r}",
                    code="RV104", path=f"{rpath}.connections.{port}")
            for t in targets:
                if not isinstance(t, str):
                    raise SpecError(
                        f"{rname}.{port}: connection target must be a "
                        f"'routine.port' string, got {t!r}",
                        code="RV104",
                        path=f"{rpath}.connections.{port}")
            conns[port] = targets
        in_aliases = dict(raw.get("inputs", {}))
        for port in in_aliases:
            if port not in rdef.inputs:
                raise SpecError(
                    f"{rname}: no input port {port!r} on {blas!r}",
                    code="RV103", path=f"{rpath}.inputs.{port}",
                    hint=f"{blas!r} inputs: {sorted(rdef.inputs)}")
        out_aliases = dict(raw.get("outputs", {}))
        for port in out_aliases:
            if port not in rdef.outputs:
                raise SpecError(
                    f"{rname}: no output port {port!r} on {blas!r}",
                    code="RV103", path=f"{rpath}.outputs.{port}",
                    hint=f"{blas!r} outputs: {sorted(rdef.outputs)}")

        placement = {k: tuple(v) for k, v in raw.get("placement",
                                                     {}).items()}
        r_vw = int(raw.get("vector_width", g_vw))
        if r_vw % 128 != 0:
            # per-routine overrides get the same lane check as the
            # global setting — previously they slipped through
            raise SpecError(
                f"{rpath}: vector_width must be a multiple of 128 "
                f"lanes (AIE vector width), got {r_vw}",
                code="RV112", path=f"{rpath}.vector_width",
                hint="use 128, 256, 384, ... (whole vector registers)")
        parsed.append(RoutineSpec(
            blas=blas, name=rname, scalars=scalars, connections=conns,
            input_aliases=in_aliases, output_aliases=out_aliases,
            window_size=int(raw.get("window_size", g_window)),
            vector_width=r_vw,
            placement=placement,
        ))

    # validate connection targets
    by_name = {r.name: r for r in parsed}
    for ri, r in enumerate(parsed):
        for out_port, targets in r.connections.items():
            cpath = f"routines[{ri}].connections.{out_port}"
            for target in targets:
                if "." not in target:
                    raise SpecError(
                        f"{r.name}.{out_port}: connection target must be "
                        f"'routine.port', got {target!r}",
                        code="RV104", path=cpath)
                tname, tport = target.rsplit(".", 1)
                if tname not in by_name:
                    raise SpecError(
                        f"{r.name}.{out_port}: unknown target routine "
                        f"{tname!r}",
                        code="RV104", path=cpath,
                        hint=f"declared routines: {sorted(by_name)}")
                if tport not in by_name[tname].rdef.inputs:
                    raise SpecError(
                        f"{r.name}.{out_port}: target {tname!r} has no "
                        f"input port {tport!r}",
                        code="RV104", path=cpath,
                        hint=f"{by_name[tname].blas!r} inputs: "
                             f"{sorted(by_name[tname].rdef.inputs)}")

    return ProgramSpec(
        name=name, dtype=_DTYPES[dtype_name], routines=tuple(parsed),
        window_size=g_window, vector_width=g_vw)


# ---------------------------------------------------------------------------
# Unparse: parsed spec -> canonical raw JSON
# ---------------------------------------------------------------------------
#
# `unparse` is the inverse of `parse` up to canonicalization: defaulted
# scalars, window sizes, and dtype become explicit, scalar literals are
# always `{"value": v}` mappings, and single-target connections stay
# strings. `parse(unparse(s))` reproduces `s` exactly.


def dtype_name(dtype) -> str:
    """The JSON name of a spec dtype (inverse of the parse mapping)."""
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise SpecError(f"unknown spec dtype {dtype!r}")


def _unparse_scalar(binding: ScalarBinding):
    if binding.kind == "value":
        return {"value": binding.value}
    return {"input": binding.input_name}


def unparse(spec: ProgramSpec) -> dict:
    """Serialize a parsed ProgramSpec back to a raw JSON-able dict."""
    routines = []
    for r in spec.routines:
        raw = {"blas": r.blas, "name": r.name}
        if r.scalars:
            raw["scalars"] = {s: _unparse_scalar(b)
                              for s, b in r.scalars.items()}
        if r.connections:
            raw["connections"] = {
                port: (targets[0] if len(targets) == 1
                       else list(targets))
                for port, targets in r.connections.items()}
        if r.input_aliases:
            raw["inputs"] = dict(r.input_aliases)
        if r.output_aliases:
            raw["outputs"] = dict(r.output_aliases)
        if r.window_size != spec.window_size:
            raw["window_size"] = r.window_size
        if r.vector_width != spec.vector_width:
            raw["vector_width"] = r.vector_width
        if r.placement:
            raw["placement"] = {k: list(v)
                                for k, v in r.placement.items()}
        routines.append(raw)
    return {
        "name": spec.name,
        "dtype": dtype_name(spec.dtype),
        "window_size": spec.window_size,
        "vector_width": spec.vector_width,
        "routines": routines,
    }


def _unparse_state_field(f: "StateField") -> dict:
    if f.is_stack:
        field = {"kind": "stack", "slots": f.slots, "of": f.of}
        if f.length is not None:
            field["len"] = f.length
        if f.like is not None:
            field["like"] = f.like
        if f.slot0 is not None:
            field["init"] = {"slot0": f.slot0}
        elif f.source is not None:
            field["init"] = {"from": f.source}
        return field
    field = {"init": f.init.src}
    if f.kind is not None:
        field["kind"] = f.kind
    return field


def _unparse_stop(stop) -> dict:
    if isinstance(stop, CountRule):
        if stop.count.ast[0] == "num":
            v = stop.count.ast[1]
            return {"count": int(v) if float(v).is_integer() else v}
        return {"count": stop.count.src}
    return {"metric": stop.metric, "init": stop.init_metric,
            "scale": stop.scale, "rtol": stop.rtol,
            "max_iters": stop.max_iters}


def _unparse_stage(stage) -> dict:
    if isinstance(stage, LetStage):
        return {"let": {n: e.src for n, e in stage.bindings}}
    if isinstance(stage, CondStage):
        c = {"if": stage.pred.src,
             "then": [_unparse_stage(s) for s in stage.then]}
        if stage.orelse:
            c["else"] = [_unparse_stage(s) for s in stage.orelse]
        return {"cond": c}
    if isinstance(stage, ReadStage):
        return {"read": {"name": stage.name, "from": stage.source,
                         "slot": stage.slot.src}}
    if isinstance(stage, StoreStage):
        s = {"into": stage.into, "slot": stage.slot.src,
             "value": stage.value}
        if stage.at is not None:
            s["at"] = stage.at.src
        return {"store": s}
    if isinstance(stage, InnerLoopStage):
        it = {}
        if stage.counter is not None:
            it["counter"] = stage.counter
        it["state"] = {f.name: _unparse_state_field(f)
                       for f in stage.state}
        it["body"] = [_unparse_stage(s) for s in stage.body]
        if stage.feedback:
            it["feedback"] = dict(stage.feedback)
        it["while"] = _unparse_stop(stage.stop)
        if stage.yields:
            it["yield"] = dict(stage.yields)
        return {"iterate": it}
    raw = {"program": dict(stage.raw_program)}
    if stage.inputs:
        raw["inputs"] = dict(stage.inputs)
    if stage.outputs:
        raw["outputs"] = dict(stage.outputs)
    return raw


def unparse_loop(lspec: "LoopSpec") -> dict:
    """Serialize a parsed LoopSpec back to a raw JSON-able dict."""
    raw = {
        "name": lspec.name,
        "dtype": dtype_name(lspec.dtype),
        "operands": dict(lspec.operands),
    }
    if lspec.setup:
        raw["setup"] = [_unparse_stage(s) for s in lspec.setup]
    state = {f.name: _unparse_state_field(f) for f in lspec.state}
    raw["iterate"] = {
        "state": state,
        "body": [_unparse_stage(s) for s in lspec.body],
        "feedback": dict(lspec.feedback),
        "while": _unparse_stop(lspec.stop),
        "solution": dict(lspec.solution),
    }
    if lspec.guards is not None:
        raw["iterate"]["guards"] = _unparse_guards(lspec.guards)
    return raw


def _unparse_guards(g: "GuardSpec") -> dict:
    out: dict = {}
    if g.nonfinite:
        out["nonfinite"] = list(g.nonfinite)
    if g.breakdown:
        out["breakdown"] = [{"value": b.value, "below": b.below}
                            for b in g.breakdown]
    if g.divergence is not None:
        out["divergence"] = {"factor": g.divergence}
    if g.stagnation is not None:
        stag: dict = {"window": g.stagnation}
        if g.min_drop:
            stag["min_drop"] = g.min_drop
        out["stagnation"] = stag
    return out


# ---------------------------------------------------------------------------
# Loop specs: JSON-described iteration ("iterate" section)
# ---------------------------------------------------------------------------

OPERAND_KINDS = ("vector", "matrix", "scalar")

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class StateField:
    """One loop-carried value. `init` is an expression over operands
    and setup-produced values; a bare name may reference a vector or
    matrix, a composite expression is scalar arithmetic.

    A field with `kind: "stack"` is a preallocated slot-indexed buffer
    (GMRES's Krylov columns / Hessenberg entries): `slots` slots of
    `of`-kind elements, read and written by `read`/`store` stages via
    slot slicing and slot updates. Element length of a vector
    stack comes from `length` (static), `like`/`slot0` (a prototype
    vector in scope), or `source` (adopt a whole `(slots, ...)` buffer
    from an env value); a matrix stack (panel history for blocked
    solvers) fixes its element shape from `like`/`slot0`/`source`
    only. Stack fields feed back automatically — the buffer as
    mutated by the iteration's stores is the next carry."""
    name: str
    init: Optional[Expr] = None
    kind: Optional[str] = None   # declared kind; inferred when None
    # stack fields only
    slots: Optional[int] = None
    of: Optional[str] = None     # element kind: vector | matrix | scalar
    length: Optional[int] = None     # static element length (vectors)
    like: Optional[str] = None       # element-length prototype value
    slot0: Optional[str] = None      # env value stored at slot 0
    source: Optional[str] = None     # env value adopted as the buffer

    @property
    def is_stack(self) -> bool:
        return self.kind == "stack"


@dataclasses.dataclass(frozen=True)
class LetStage:
    """Scalar update expressions, evaluated in order (`alpha = rz/pq`).
    These are the spec-level scalar feedback edges that used to live in
    per-solver Python glue."""
    bindings: Tuple   # ((name, Expr), ...) in spec order


@dataclasses.dataclass(frozen=True)
class ProgramStage:
    """One dataflow program invocation inside a loop. `inputs` maps the
    inner program's public input names to loop-environment names
    (operands, state, or values produced earlier this iteration);
    `outputs` maps program outputs to fresh environment names. Both
    default to the identity."""
    program: ProgramSpec
    raw_program: Mapping   # the raw dict, kept for digest-keyed caching
    inputs: Mapping
    outputs: Mapping


@dataclasses.dataclass(frozen=True)
class CondStage:
    """A conditional stage: `pred` (a validated comparison over the
    loop env — the loop executor's `threshold` scalar included) picks
    which branch's stages run. Only names produced by
    BOTH branches (with matching kinds) survive into the environment
    after the cond; branch-local extras stay local."""
    pred: Expr
    then: Tuple     # stage list
    orelse: Tuple   # stage list (may be empty)


@dataclasses.dataclass(frozen=True)
class ReadStage:
    """Bind `name` to slot `slot` (a scalar index expression) of
    `source`, sliced along the leading axis: a vector-stack slot is a
    vector, a scalar-stack slot is a scalar, a matrix row is a vector,
    a vector element is a scalar."""
    name: str
    source: str
    slot: Expr


@dataclasses.dataclass(frozen=True)
class StoreStage:
    """Write `value` into slot `slot` of stack state field `into`
    (a slot update). With `at`, write a scalar into element
    `at` of a vector-stack slot instead of replacing the whole slot.
    Stores mutate the stack within the iteration — the only exemption
    from single-assignment — and the mutated buffer is what feeds
    back."""
    into: str
    slot: Expr
    value: str
    at: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class CountRule:
    """Inner-loop stop rule: run exactly `count` iterations. `count`
    is a scalar expression over the enclosing environment (usually a
    literal — GMRES's restart length m), evaluated once at loop
    entry."""
    count: Expr


@dataclasses.dataclass(frozen=True)
class InnerLoopStage:
    """A nested `iterate` inside a loop body: its own state (stacks
    included), staged body, feedback edges, and stop rule — lowered to
    a loop inside the enclosing loop.
    `counter` (optional) names the int32 iteration index in the inner
    body's scope; `yields` exports final inner-state fields into the
    enclosing environment."""
    counter: Optional[str]
    state: Tuple                  # (StateField, ...)
    body: Tuple                   # stage list
    feedback: Mapping[str, str]
    stop: object                  # CountRule | StopRule
    yields: Mapping[str, str]     # enclosing env name -> state field


@dataclasses.dataclass(frozen=True)
class StopRule:
    """`while` section: iterate until metric <= rtol * scale or
    max_iters. `metric` names a body-produced scalar; `init_metric`
    (default: same name) must be produced by setup and seeds the
    residual history; `scale` is a setup-produced scalar name or a
    literal."""
    metric: str
    init_metric: str
    scale: Union[str, float]
    rtol: float
    max_iters: int


@dataclasses.dataclass(frozen=True)
class BreakdownGuard:
    """One Krylov-breakdown sentinel: trip when `|value| < below`
    (`value` is a body-produced scalar — CG's p'Ap, BiCGStab's rho)."""
    value: str
    below: float


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """`iterate.guards` section: cheap in-loop failure predicates the
    loop executor folds into the loop's condition so a poisoned solve exits
    in O(1) iterations with a diagnosis instead of running all
    `max_iters`. Any guards section (even an empty one) also makes the
    loop executor check the stop metric with `isfinite` every iteration.

    * `nonfinite`  — body-env names checked with `isfinite` (vectors
      are reduced with `all`); a hit reports NONFINITE.
    * `breakdown`  — `|scalar| < below` sentinels; report BREAKDOWN.
    * `divergence` — metric > factor * max(init_metric, tiny); reports
      DIVERGED.
    * `stagnation` — `window` consecutive iterations without the
      metric improving on its best by a relative `min_drop`; reports
      STAGNATED.
    """
    nonfinite: Tuple[str, ...] = ()
    breakdown: Tuple[BreakdownGuard, ...] = ()
    divergence: Optional[float] = None   # factor over init_metric
    stagnation: Optional[int] = None     # window (iterations)
    min_drop: float = 0.0                # relative improvement to reset


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """A parsed loop program: the spec-level analogue of an iterative
    solver."""
    name: str
    dtype: torch.dtype
    operands: Mapping[str, str]       # name -> vector|matrix|scalar
    setup: Tuple                      # (LetStage|ProgramStage, ...)
    state: Tuple                      # (StateField, ...)
    body: Tuple                       # (LetStage|ProgramStage, ...)
    feedback: Mapping[str, str]       # state field -> env value name
    stop: StopRule
    solution: Mapping[str, str]       # public output -> state field
    guards: Optional[GuardSpec] = None

    def state_field(self, name: str) -> StateField:
        for f in self.state:
            if f.name == name:
                return f
        raise KeyError(name)


def is_loop_spec(raw) -> bool:
    """True if the raw mapping describes a loop program."""
    return isinstance(raw, Mapping) and "iterate" in raw


def _parse_ident(name, where) -> str:
    if not isinstance(name, str) or not _IDENT.match(name):
        raise SpecError(
            f"{where}: {name!r} is not a valid identifier (loop names "
            f"must be expression-referencable)",
            code="RV211", path=where)
    return name


def _parse_expr(src, where) -> Expr:
    try:
        return parse_expr(src)
    except ExprError as e:
        raise SpecError(f"{where}: {e}", code="RV211",
                        path=where) from None


def _parse_pred(src, where) -> Expr:
    try:
        return parse_pred(src)
    except ExprError as e:
        raise SpecError(f"{where}: {e}", code="RV211",
                        path=where) from None


STAGE_KINDS = ("let", "program", "cond", "read", "store", "iterate")


def _parse_stages(raw_list, where, *, dtype_name):
    if not isinstance(raw_list, (list, tuple)):
        raise SpecError(
            f"{where}: expected a stage list, got {type(raw_list).__name__}")
    return tuple(
        _parse_stage(s, f"{where}[{i}]", dtype_name=dtype_name)
        for i, s in enumerate(raw_list))


def _parse_stage(raw, where, *, dtype_name):
    if not isinstance(raw, Mapping):
        raise SpecError(f"{where}: stage must be a mapping, got {raw!r}")
    tags = [k for k in STAGE_KINDS if k in raw]
    if len(tags) != 1:
        raise SpecError(
            f"{where}: stage must have exactly one of "
            f"{'/'.join(STAGE_KINDS)}, got keys {sorted(raw)}",
            code="RV211", path=where,
            hint=f"tag each stage with exactly one of "
                 f"{'/'.join(STAGE_KINDS)}")
    tag = tags[0]

    if tag == "let":
        unknown = set(raw) - {"let"}
        if unknown:
            raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
        if not isinstance(raw["let"], Mapping) or not raw["let"]:
            raise SpecError(f"{where}: 'let' must be a non-empty mapping")
        bindings = tuple(
            (_parse_ident(n, where), _parse_expr(e, f"{where}.{n}"))
            for n, e in raw["let"].items())
        return LetStage(bindings=bindings)

    if tag == "cond":
        unknown = set(raw) - {"cond"}
        if unknown:
            raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
        c = raw["cond"]
        if not isinstance(c, Mapping):
            raise SpecError(f"{where}.cond: must be a mapping")
        unknown = set(c) - {"if", "then", "else"}
        if unknown:
            raise SpecError(
                f"{where}.cond: unknown keys {sorted(unknown)}")
        if "if" not in c:
            raise SpecError(f"{where}.cond.if: predicate is required")
        pred = _parse_pred(c["if"], f"{where}.cond.if")
        raw_then = c.get("then")
        if not isinstance(raw_then, (list, tuple)) or not raw_then:
            raise SpecError(
                f"{where}.cond.then: must be a non-empty stage list")
        then = _parse_stages(raw_then, f"{where}.cond.then",
                             dtype_name=dtype_name)
        orelse = _parse_stages(c.get("else", []), f"{where}.cond.else",
                               dtype_name=dtype_name)
        return CondStage(pred=pred, then=then, orelse=orelse)

    if tag == "read":
        unknown = set(raw) - {"read"}
        if unknown:
            raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
        r = raw["read"]
        if not isinstance(r, Mapping):
            raise SpecError(f"{where}.read: must be a mapping")
        unknown = set(r) - {"name", "from", "slot"}
        if unknown:
            raise SpecError(
                f"{where}.read: unknown keys {sorted(unknown)}")
        for k in ("name", "from", "slot"):
            if k not in r:
                raise SpecError(f"{where}.read.{k}: required")
        return ReadStage(
            name=_parse_ident(r["name"], f"{where}.read.name"),
            source=_parse_ident(r["from"], f"{where}.read.from"),
            slot=_parse_expr(r["slot"], f"{where}.read.slot"))

    if tag == "store":
        unknown = set(raw) - {"store"}
        if unknown:
            raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
        s = raw["store"]
        if not isinstance(s, Mapping):
            raise SpecError(f"{where}.store: must be a mapping")
        unknown = set(s) - {"into", "slot", "value", "at"}
        if unknown:
            raise SpecError(
                f"{where}.store: unknown keys {sorted(unknown)}")
        for k in ("into", "slot", "value"):
            if k not in s:
                raise SpecError(f"{where}.store.{k}: required")
        at = s.get("at")
        return StoreStage(
            into=_parse_ident(s["into"], f"{where}.store.into"),
            slot=_parse_expr(s["slot"], f"{where}.store.slot"),
            value=_parse_ident(s["value"], f"{where}.store.value"),
            at=(None if at is None
                else _parse_expr(at, f"{where}.store.at")))

    if tag == "iterate":
        unknown = set(raw) - {"iterate"}
        if unknown:
            raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
        return _parse_inner_iterate(raw["iterate"], f"{where}.iterate",
                                    dtype_name=dtype_name)

    # tag == "program"
    unknown = set(raw) - {"program", "inputs", "outputs"}
    if unknown:
        raise SpecError(f"{where}: unknown stage keys {sorted(unknown)}")
    raw_prog = raw["program"]
    if not isinstance(raw_prog, Mapping):
        raise SpecError(f"{where}: 'program' must be a spec mapping")
    if "dtype" not in raw_prog and dtype_name != "float32":
        # inner programs inherit a non-default loop dtype unless they
        # pin one; the float32 default is left implicit so the spec
        # digest — and therefore the program cache entry — stays
        # identical to the same body dict compiled outside a loop
        raw_prog = {**raw_prog, "dtype": dtype_name}
    pspec = parse(raw_prog)
    ins = dict(raw.get("inputs", {}))
    outs = dict(raw.get("outputs", {}))
    for m, label in ((ins, "inputs"), (outs, "outputs")):
        for k, v in m.items():
            if not isinstance(v, str):
                raise SpecError(
                    f"{where}.{label}[{k!r}]: binding must be an "
                    f"environment name string, got {v!r}")
    return ProgramStage(program=pspec, raw_program=raw_prog,
                        inputs=ins, outputs=outs)


def _parse_state_field(sname, sraw, where) -> StateField:
    """One `state` entry: a regular loop-carried value (init
    expression) or a `kind: "stack"` slot-indexed buffer."""
    if isinstance(sraw, str):
        sraw = {"init": sraw}
    if not isinstance(sraw, Mapping):
        raise SpecError(
            f"{where}: state field must be an init string or a "
            f"mapping, got {sraw!r}")
    kind = sraw.get("kind")

    if kind == "stack":
        unknown = set(sraw) - {"kind", "slots", "of", "init", "len",
                               "like"}
        if unknown:
            raise SpecError(f"{where}: unknown stack keys "
                            f"{sorted(unknown)}")
        slots = sraw.get("slots")
        if not isinstance(slots, int) or isinstance(slots, bool) \
                or slots <= 0:
            raise SpecError(
                f"{where}.slots: a stack needs a static positive slot "
                f"count, got {slots!r}")
        of = sraw.get("of")
        if of not in ("vector", "matrix", "scalar"):
            raise SpecError(
                f"{where}.of: stack element kind must be 'vector', "
                f"'matrix' or 'scalar', got {of!r}")
        length = sraw.get("len")
        if length is not None and (not isinstance(length, int)
                                   or isinstance(length, bool)
                                   or length <= 0):
            raise SpecError(
                f"{where}.len: element length must be a static "
                f"positive int, got {length!r}")
        like = sraw.get("like")
        if like is not None:
            _parse_ident(like, f"{where}.like")
        if of == "scalar" and (length is not None or like is not None):
            raise SpecError(
                f"{where}: 'len'/'like' only apply to vector stacks "
                f"(scalar slots have no element length)")
        if of == "matrix" and length is not None:
            raise SpecError(
                f"{where}: a matrix stack has a 2-D element shape — "
                f"use 'like', 'init.slot0' or 'init.from' instead of "
                f"'len'")
        slot0 = source = None
        init = sraw.get("init")
        if init is not None:
            if not isinstance(init, Mapping) or \
                    len(set(init) & {"slot0", "from"}) != 1 or \
                    set(init) - {"slot0", "from"}:
                raise SpecError(
                    f"{where}.init: stack init must be "
                    f"{{'slot0': name}} (zeros with slot 0 seeded) or "
                    f"{{'from': name}} (adopt a whole (slots, ...) "
                    f"buffer), got {init!r}")
            if "slot0" in init:
                slot0 = _parse_ident(init["slot0"],
                                     f"{where}.init.slot0")
            else:
                source = _parse_ident(init["from"],
                                      f"{where}.init.from")
        if source is not None and (length is not None
                                   or like is not None):
            raise SpecError(
                f"{where}: init.from adopts the whole buffer — "
                f"'len'/'like' conflict with it")
        if of == "vector" and length is None and like is None \
                and slot0 is None and source is None:
            raise SpecError(
                f"{where}: a vector stack needs 'len', 'like', "
                f"'init.slot0' or 'init.from' to fix its element "
                f"length")
        if of == "matrix" and like is None and slot0 is None \
                and source is None:
            raise SpecError(
                f"{where}: a matrix stack needs 'like', 'init.slot0' "
                f"or 'init.from' to fix its element shape")
        return StateField(name=sname, kind="stack", slots=slots,
                          of=of, length=length, like=like,
                          slot0=slot0, source=source)

    if "init" not in sraw:
        raise SpecError(f"{where}: needs an 'init' binding")
    if kind is not None and kind not in OPERAND_KINDS:
        raise SpecError(f"{where}: unknown kind {kind!r}")
    unknown = set(sraw) - {"init", "kind"}
    if unknown:
        raise SpecError(f"{where}: unknown state keys {sorted(unknown)}")
    return StateField(name=sname,
                      init=_parse_expr(sraw["init"], f"{where}.init"),
                      kind=kind)


def _parse_state(raw_state, where) -> Tuple:
    if not isinstance(raw_state, Mapping) or not raw_state:
        raise SpecError(f"{where} must be a non-empty mapping")
    fields = []
    for sname, sraw in raw_state.items():
        _parse_ident(sname, where)
        fields.append(_parse_state_field(sname, sraw,
                                         f"{where}.{sname}"))
    return tuple(fields)


def _parse_feedback(it, state, where):
    """Validate feedback edges against the state fields; stacks feed
    back automatically and may not appear. A loop needs at least one
    feedback edge or one stack field to make progress."""
    state_names = {f.name for f in state}
    stacks = {f.name for f in state if f.is_stack}
    feedback = dict(it.get("feedback", {}))
    for fname, src in feedback.items():
        if fname not in state_names:
            raise SpecError(
                f"{where}: unknown state field {fname!r}; "
                f"declared state: {sorted(state_names)}",
                code="RV211", path=f"{where}.{fname}",
                hint=f"declared state: {sorted(state_names)}")
        if fname in stacks:
            raise SpecError(
                f"{where}.{fname}: stack state feeds back "
                f"automatically (the buffer as mutated by the "
                f"iteration's stores); remove the explicit edge",
                code="RV211", path=f"{where}.{fname}")
        if not isinstance(src, str) or not _IDENT.match(src):
            raise SpecError(
                f"{where}.{fname}: source must be an "
                f"environment name, got {src!r}",
                code="RV211", path=f"{where}.{fname}")
    if not feedback and not stacks:
        raise SpecError(
            f"{where} is empty: a loop with no feedback edge "
            f"computes the same iterate forever",
            code="RV211", path=where,
            hint="add a feedback edge (state field -> body value) or "
                 "a stack state field")
    return feedback


def _parse_inner_iterate(it, where, *, dtype_name) -> InnerLoopStage:
    if not isinstance(it, Mapping):
        raise SpecError(f"{where}: must be a mapping")
    unknown = set(it) - {"counter", "state", "body", "feedback",
                         "while", "yield"}
    if unknown:
        raise SpecError(f"{where}: unknown keys {sorted(unknown)} "
                        f"(inner loops yield, they have no solution)")
    counter = it.get("counter")
    if counter is not None:
        counter = _parse_ident(counter, f"{where}.counter")

    state = _parse_state(it.get("state"), f"{where}.state")
    state_names = {f.name for f in state}

    raw_body = it.get("body")
    if not isinstance(raw_body, (list, tuple)) or not raw_body:
        raise SpecError(f"{where}.body must be a non-empty stage list")
    body = _parse_stages(raw_body, f"{where}.body",
                         dtype_name=dtype_name)

    feedback = _parse_feedback(it, state, f"{where}.feedback")

    raw_stop = it.get("while")
    if not isinstance(raw_stop, Mapping):
        raise SpecError(f"{where}.while stop rule is required")
    if "count" in raw_stop:
        unknown = set(raw_stop) - {"count"}
        if unknown:
            raise SpecError(
                f"{where}.while: 'count' is a complete stop rule; "
                f"unknown extra keys {sorted(unknown)}")
        stop = CountRule(count=_parse_expr(raw_stop["count"],
                                           f"{where}.while.count"))
    else:
        unknown = set(raw_stop) - {"metric", "init", "scale", "rtol",
                                   "max_iters"}
        if unknown:
            raise SpecError(
                f"{where}.while: unknown keys {sorted(unknown)}")
        metric = raw_stop.get("metric")
        if not isinstance(metric, str) or not _IDENT.match(metric):
            raise SpecError(
                f"{where}.while.metric must name a body-produced "
                f"scalar (or use a 'count' rule)")
        if "max_iters" not in raw_stop:
            raise SpecError(
                f"{where}.while.max_iters: an inner metric rule "
                f"needs a static max_iters bound")
        init_metric = raw_stop.get("init", metric)
        _parse_ident(init_metric, f"{where}.while.init")
        scale = raw_stop.get("scale", 1.0)
        if isinstance(scale, str):
            _parse_ident(scale, f"{where}.while.scale")
        elif isinstance(scale, (int, float)):
            scale = float(scale)
        else:
            raise SpecError(
                f"{where}.while.scale must be an env value name or a "
                f"number, got {scale!r}")
        stop = StopRule(
            metric=metric, init_metric=init_metric, scale=scale,
            rtol=float(raw_stop.get("rtol", 1e-6)),
            max_iters=int(raw_stop["max_iters"]))
        if stop.max_iters <= 0:
            raise SpecError(f"{where}.while.max_iters must be positive")

    yields = dict(it.get("yield", {}))
    for outer_name, src in yields.items():
        _parse_ident(outer_name, f"{where}.yield")
        if src not in state_names:
            raise SpecError(
                f"{where}.yield.{outer_name}: source {src!r} is not "
                f"an inner state field (yields export the final inner "
                f"state)")
    return InnerLoopStage(counter=counter, state=state, body=body,
                          feedback=feedback, stop=stop, yields=yields)


def _parse_guards(raw_guards, where) -> GuardSpec:
    """Parse and structurally validate an `iterate.guards` section.
    Name resolution (does `pq` exist, is it a scalar) happens in
    `lowering.lower_loop` where body-env kinds are known."""
    if not isinstance(raw_guards, Mapping):
        raise SpecError(
            f"{where}: guards must be a mapping, got "
            f"{type(raw_guards).__name__}",
            code="RV500", path=where,
            hint="guards: {nonfinite: [...], breakdown: [...], "
                 "divergence: {...}, stagnation: {...}}")
    unknown = set(raw_guards) - {"nonfinite", "breakdown", "divergence",
                                 "stagnation"}
    if unknown:
        raise SpecError(
            f"{where}: unknown guard kinds {sorted(unknown)}",
            code="RV500", path=where,
            hint="known guard kinds: nonfinite, breakdown, "
                 "divergence, stagnation")

    raw_nf = raw_guards.get("nonfinite", [])
    if not isinstance(raw_nf, (list, tuple)):
        raise SpecError(
            f"{where}.nonfinite must be a list of env value names",
            code="RV500", path=f"{where}.nonfinite")
    nonfinite = tuple(_parse_ident(n, f"{where}.nonfinite[{i}]")
                      for i, n in enumerate(raw_nf))

    raw_bd = raw_guards.get("breakdown", [])
    if not isinstance(raw_bd, (list, tuple)):
        raise SpecError(
            f"{where}.breakdown must be a list of "
            f"{{value, below}} sentinels",
            code="RV500", path=f"{where}.breakdown")
    breakdown = []
    for i, b in enumerate(raw_bd):
        bwhere = f"{where}.breakdown[{i}]"
        if not isinstance(b, Mapping) or set(b) - {"value", "below"}:
            raise SpecError(
                f"{bwhere}: expected {{value, below}}, got {b!r}",
                code="RV500", path=bwhere)
        value = _parse_ident(b.get("value"), f"{bwhere}.value")
        below = b.get("below", 1e-30)
        if not isinstance(below, (int, float)) or \
                isinstance(below, bool) or not below > 0:
            raise SpecError(
                f"{bwhere}.below must be a positive number, got "
                f"{below!r}",
                code="RV503", path=f"{bwhere}.below")
        breakdown.append(BreakdownGuard(value=value, below=float(below)))

    divergence = None
    raw_dv = raw_guards.get("divergence")
    if raw_dv is not None:
        dwhere = f"{where}.divergence"
        if not isinstance(raw_dv, Mapping) or set(raw_dv) - {"factor"}:
            raise SpecError(
                f"{dwhere}: expected {{factor}}, got {raw_dv!r}",
                code="RV500", path=dwhere)
        factor = raw_dv.get("factor", 1e5)
        if not isinstance(factor, (int, float)) or \
                isinstance(factor, bool) or not factor > 1:
            raise SpecError(
                f"{dwhere}.factor must be a number > 1, got {factor!r}",
                code="RV503", path=f"{dwhere}.factor",
                hint="divergence trips when the metric exceeds "
                     "factor * its initial value")
        divergence = float(factor)

    stagnation, min_drop = None, 0.0
    raw_sg = raw_guards.get("stagnation")
    if raw_sg is not None:
        swhere = f"{where}.stagnation"
        if not isinstance(raw_sg, Mapping) or \
                set(raw_sg) - {"window", "min_drop"}:
            raise SpecError(
                f"{swhere}: expected {{window, min_drop?}}, got "
                f"{raw_sg!r}",
                code="RV500", path=swhere)
        window = raw_sg.get("window")
        if not isinstance(window, int) or isinstance(window, bool) \
                or window < 1:
            raise SpecError(
                f"{swhere}.window must be a positive int, got "
                f"{window!r}",
                code="RV503", path=f"{swhere}.window")
        min_drop = raw_sg.get("min_drop", 0.0)
        if not isinstance(min_drop, (int, float)) or \
                isinstance(min_drop, bool) or not 0 <= min_drop < 1:
            raise SpecError(
                f"{swhere}.min_drop must be a number in [0, 1), got "
                f"{min_drop!r}",
                code="RV503", path=f"{swhere}.min_drop")
        stagnation, min_drop = window, float(min_drop)

    return GuardSpec(nonfinite=nonfinite, breakdown=tuple(breakdown),
                     divergence=divergence, stagnation=stagnation,
                     min_drop=min_drop)


def parse_loop(raw: Union[str, Mapping, pathlib.Path]) -> LoopSpec:
    """Parse and structurally validate a loop-program spec.

    Kind inference and def-use validation across stages (scalar fed to
    a window port, forward references, feedback typing) happen in
    `core.lowering.lower_loop`, where the inner programs' IO is known.
    """
    if isinstance(raw, pathlib.Path):
        raw = json.loads(raw.read_text())
    elif isinstance(raw, str):
        raw = json.loads(raw)
    if not isinstance(raw, Mapping):
        raise SpecError(f"loop spec must be a mapping, got {type(raw)}")
    if "iterate" not in raw:
        raise SpecError("loop spec has no 'iterate' section")
    unknown = set(raw) - {"name", "dtype", "operands", "setup",
                          "iterate"}
    if unknown:
        raise SpecError(
            f"loop spec: unknown top-level keys {sorted(unknown)} "
            f"(did a section escape 'iterate'?)",
            code="RV211", path=sorted(unknown)[0],
            hint="move solver sections (state/body/feedback/while/"
                 "solution) inside 'iterate'")

    name = raw.get("name", "loop")
    dtype_name = raw.get("dtype", "float32")
    if dtype_name not in _DTYPES:
        raise SpecError(f"unsupported dtype {dtype_name!r}",
                        code="RV111", path="dtype",
                        hint=f"supported: {', '.join(sorted(_DTYPES))}")

    raw_ops = raw.get("operands")
    if not isinstance(raw_ops, Mapping) or not raw_ops:
        raise SpecError(
            "loop spec needs an 'operands' mapping of name -> "
            f"{'|'.join(OPERAND_KINDS)}")
    operands = {}
    for oname, okind in raw_ops.items():
        _parse_ident(oname, "operands")
        if okind not in OPERAND_KINDS:
            raise SpecError(
                f"operand {oname!r}: unknown kind {okind!r}; expected "
                f"one of {OPERAND_KINDS}",
                code="RV211", path=f"operands.{oname}",
                hint=f"declare each operand as one of "
                     f"{'|'.join(OPERAND_KINDS)}")
        operands[oname] = okind

    setup = tuple(
        _parse_stage(s, f"setup[{i}]", dtype_name=dtype_name)
        for i, s in enumerate(raw.get("setup", [])))

    it = raw["iterate"]
    if not isinstance(it, Mapping):
        raise SpecError("'iterate' must be a mapping")
    unknown = set(it) - {"state", "body", "feedback", "while",
                         "solution", "guards"}
    if unknown:
        raise SpecError(f"iterate: unknown keys {sorted(unknown)}")

    state = _parse_state(it.get("state"), "iterate.state")
    for f in state:
        if f.name in operands:
            raise SpecError(
                f"iterate.state: {f.name!r} shadows an operand")
    state_names = {f.name for f in state}

    raw_body = it.get("body")
    if not isinstance(raw_body, (list, tuple)) or not raw_body:
        raise SpecError("iterate.body must be a non-empty stage list")
    body = _parse_stages(raw_body, "iterate.body",
                         dtype_name=dtype_name)

    feedback = _parse_feedback(it, state, "iterate.feedback")

    raw_stop = it.get("while")
    if not isinstance(raw_stop, Mapping):
        raise SpecError("iterate.while stop rule is required")
    unknown = set(raw_stop) - {"metric", "init", "scale", "rtol",
                               "max_iters"}
    if unknown:
        raise SpecError(f"iterate.while: unknown keys {sorted(unknown)}")
    metric = raw_stop.get("metric")
    if not isinstance(metric, str) or not _IDENT.match(metric):
        raise SpecError(
            "iterate.while.metric must name a body-produced scalar")
    init_metric = raw_stop.get("init", metric)
    _parse_ident(init_metric, "iterate.while.init")
    scale = raw_stop.get("scale", 1.0)
    if isinstance(scale, str):
        _parse_ident(scale, "iterate.while.scale")
    elif isinstance(scale, (int, float)):
        scale = float(scale)
    else:
        raise SpecError(
            f"iterate.while.scale must be a setup value name or a "
            f"number, got {scale!r}")
    stop = StopRule(
        metric=metric, init_metric=init_metric, scale=scale,
        rtol=float(raw_stop.get("rtol", 1e-6)),
        max_iters=int(raw_stop.get("max_iters", 100)))
    if stop.max_iters <= 0:
        raise SpecError("iterate.while.max_iters must be positive")

    guards = None
    if "guards" in it:
        guards = _parse_guards(it["guards"], "iterate.guards")

    solution = dict(it.get("solution", {"x": "x"}))
    if not solution:
        raise SpecError("iterate.solution must not be empty",
                        code="RV211", path="iterate.solution")
    for pub, src in solution.items():
        if src not in state_names:
            raise SpecError(
                f"iterate.solution.{pub}: source {src!r} is not a "
                f"state field (solutions are read from the final "
                f"loop state)",
                code="RV211", path=f"iterate.solution.{pub}",
                hint=f"declared state: {sorted(state_names)}")

    return LoopSpec(
        name=name, dtype=_DTYPES[dtype_name], operands=operands,
        setup=setup, state=state, body=body, feedback=feedback,
        stop=stop, solution=solution, guards=guards)
