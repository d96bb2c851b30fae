"""Fluent ProgramBuilder: programmatic construction of validated
ProgramSpecs (dataflow AND loop programs) that round-trip losslessly
to/from the raw JSON the rest of the pipeline consumes.

    from repro_torch import blas

    b = blas.program("axpydot")
    z = b.axpy(alpha=b.input("neg_alpha"), x="v", y="w")
    b.dot(x=z, y="u", out="beta")
    exe = blas.compile(b)

Every registry routine is a method on the builder (`b.axpy`, `b.gemv`,
...) — new `core.routines` entries appear for free. Routine kwargs
bind ports and scalars:

    number          -> scalar literal                 {"value": v}
    str / b.input() -> public program input alias     {"input": s}
    Port            -> on-chip edge from an earlier routine's output

The call returns the routine's output Port (a dict of Ports for
multi-output routines like `rot`), and `out="name"` aliases the
output to a public program output.

Loop programs use the same builder: declare `b.operand(...)`, optional
`b.setup(...)` stages, then one `b.iterate(state=..., body=...,
feedback=..., stop=..., solution=...)` — stage lists accept raw stage
dicts, `blas.let(alpha="rz / pq")`, and `blas.stage(prog, ...)` where
`prog` is a raw spec dict or another ProgramBuilder.

Grammar-v2 loop handles make the full iterate grammar reachable
fluently:

    v = b.state("V", slots=21, of="vector", slot0="v0")   # a stack
    b.state("x", init="x0")                               # StateRefs
    b.feedback(x="x_next")              # accumulates edges for iterate
    b.cond("snorm <= threshold", then=[...], orelse=[...])
    b.inner_loop(counter="j", state={...}, body=[
        blas.read("vj", v, "j"), ...,
        blas.store(v, "j + 1", "vnext"),
    ], count=20, yields={"Vb": v})

`b.cond(...)` / `b.inner_loop(...)` / `blas.read` / `blas.store`
return stage dicts for body lists; `b.state(...)` / `b.feedback(...)`
accumulate, and a later `b.iterate(body=..., stop=...)` picks them up
without repeating the mappings.

Round-trip guarantee: `ProgramBuilder.from_spec(raw)` keeps the raw
form verbatim (which defaults were implicit, bare-number scalars,
string vs list connection targets), so `from_spec(x).to_spec()` is
digest-identical to `x` under `core.lowering.spec_digest` — the
program cache cannot be split by a builder round-trip.
"""
from __future__ import annotations

import copy
import json
import pathlib
from typing import Mapping, Optional, Union

from repro_torch.core import lowering, routines as R, spec as spec_mod
from repro_torch.core.spec import LoopSpec, ProgramSpec, SpecError


class BuilderError(SpecError):
    """Builder misuse: unknown routine, dangling port, duplicate name,
    or mixing dataflow and loop construction."""


class Port:
    """Handle to one routine output inside a builder — passing it to a
    later routine call creates the on-chip edge."""

    __slots__ = ("builder", "routine", "port")

    def __init__(self, builder: "ProgramBuilder", routine: str,
                 port: str):
        self.builder = builder
        self.routine = routine
        self.port = port

    def __repr__(self):
        return f"Port({self.routine}.{self.port})"


class InputRef:
    """Handle to a named public program input (`b.input("alpha")`) —
    sugar for the equivalent string alias, with identifier checking."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        if not isinstance(name, str) or not spec_mod._IDENT.match(name):
            raise BuilderError(
                f"input name must be an identifier, got {name!r}")
        self.name = name

    def __repr__(self):
        return f"InputRef({self.name})"


class StateRef:
    """Handle to a declared loop state field (`b.state(...)`) — usable
    wherever the JSON grammar expects the field's name (read/store
    targets, feedback keys via kwargs, yields, solution sources)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"StateRef({self.name})"

    def __str__(self):
        return self.name


def _name_of(v) -> str:
    return v.name if isinstance(v, StateRef) else v


def let(**bindings) -> dict:
    """A scalar-update loop stage: `blas.let(alpha="rz / pq")`.
    Binding order is preserved (kwargs are ordered)."""
    if not bindings:
        raise BuilderError("let() needs at least one binding")
    return {"let": {n: e for n, e in bindings.items()}}


def cond(pred: str, then, orelse=None) -> dict:
    """A conditional loop stage: `blas.cond("snorm <= threshold",
    then=[...], orelse=[...])`. Branch lists accept the same stage
    forms as any body list."""
    c = {"if": pred, "then": [_as_stage(s) for s in then]}
    if orelse:
        c["else"] = [_as_stage(s) for s in orelse]
    return {"cond": c}


def read(name: str, source, slot) -> dict:
    """A slot-read loop stage: `blas.read("vj", V, "j")` binds `name`
    to slot `slot` of `source` (a stack StateRef or env value name)."""
    return {"read": {"name": name, "from": _name_of(source),
                     "slot": slot}}


def store(into, slot, value: str, at=None) -> dict:
    """A slot-store loop stage: `blas.store(V, "j + 1", "vnext")`;
    with `at`, writes scalar `value` at element `at` of the slot."""
    s = {"into": _name_of(into), "slot": slot, "value": value}
    if at is not None:
        s["at"] = at
    return {"store": s}


def _state_entry(v) -> dict:
    if isinstance(v, Mapping):
        return dict(v)
    return {"init": v}


def inner_loop(*, state: Mapping, body, counter: Optional[str] = None,
               feedback: Optional[Mapping] = None, count=None,
               stop: Optional[Mapping] = None,
               yields: Optional[Mapping] = None) -> dict:
    """A nested-iterate loop stage (GMRES's m-cycle). Exactly one of
    `count` (a trip count — int or expression) or `stop` (a metric
    while-rule mapping with max_iters) is required; `yields` exports
    final inner state into the enclosing environment."""
    if (count is None) == (stop is None):
        raise BuilderError(
            "inner_loop() needs exactly one of count= (trip count) or "
            "stop= (metric while rule)")
    it: dict = {}
    if counter is not None:
        it["counter"] = counter
    it["state"] = {n: _state_entry(v) for n, v in dict(state).items()}
    it["body"] = [_as_stage(s) for s in body]
    if feedback:
        it["feedback"] = {k: _name_of(v)
                          for k, v in dict(feedback).items()}
    it["while"] = {"count": count} if count is not None else dict(stop)
    if yields:
        it["yield"] = {k: _name_of(v)
                       for k, v in dict(yields).items()}
    return {"iterate": it}


def stage(program, inputs: Optional[Mapping] = None,
          outputs: Optional[Mapping] = None) -> dict:
    """A dataflow-program loop stage. `program` is a raw spec dict or
    a ProgramBuilder; `inputs`/`outputs` rebind the inner program's
    public names to loop-environment names."""
    if isinstance(program, ProgramBuilder):
        program = program.to_spec()
    if not isinstance(program, Mapping):
        raise BuilderError(
            f"stage program must be a spec dict or ProgramBuilder, "
            f"got {type(program).__name__}")
    raw = {"program": dict(program)}
    if inputs:
        raw["inputs"] = dict(inputs)
    if outputs:
        raw["outputs"] = dict(outputs)
    return raw


class ProgramBuilder:
    """Accumulates a spec programmatically; serializes with
    `to_spec()` and reconstructs losslessly with `from_spec()`."""

    def __init__(self, name: Optional[str] = None, *,
                 dtype: Optional[str] = None,
                 window_size: Optional[int] = None,
                 vector_width: Optional[int] = None):
        self._top: dict = {}
        if name is not None:
            self._top["name"] = name
        if dtype is not None:
            if dtype not in spec_mod._DTYPES:
                raise BuilderError(
                    f"unsupported dtype {dtype!r}; expected one of "
                    f"{sorted(spec_mod._DTYPES)}")
            self._top["dtype"] = dtype
        if window_size is not None:
            self._top["window_size"] = int(window_size)
        if vector_width is not None:
            self._top["vector_width"] = int(vector_width)
        self._routines: list = []        # raw routine dicts, in order
        self._by_name: dict = {}         # routine name -> raw dict
        self._operands: dict = {}        # loop programs only
        self._setup: list = []
        self._state: dict = {}           # accumulated b.state(...) fields
        self._feedback: dict = {}        # accumulated b.feedback(...) edges
        self._iterate: Optional[dict] = None

    # -- introspection ---------------------------------------------------

    @property
    def is_loop(self) -> bool:
        return bool(self._operands) or bool(self._state) \
            or bool(self._feedback) or self._iterate is not None

    def __repr__(self):
        kind = "loop" if self.is_loop else "dataflow"
        n = (len(self._routines) if not self.is_loop
             else len(self._operands))
        return (f"ProgramBuilder({self._top.get('name', '?')!r}, "
                f"{kind}, {n} {'operands' if self.is_loop else 'routines'})")

    # -- dataflow construction -------------------------------------------

    def input(self, name: str) -> InputRef:
        """Reference a public program input by name."""
        return InputRef(name)

    def __getattr__(self, attr):
        # routine methods are resolved from the registry, so new
        # registered routines become builder methods for free
        if attr.startswith("_"):
            raise AttributeError(attr)
        try:
            R.get(attr)
        except KeyError:
            raise AttributeError(
                f"ProgramBuilder has no attribute {attr!r} and the "
                f"routine registry has no routine {attr!r}; available "
                f"routines: {list(R.names())}") from None
        return lambda **kw: self.add(attr, **kw)

    def _auto_name(self, blas: str) -> str:
        k = 0
        while f"{blas}{k}" in self._by_name:
            k += 1
        return f"{blas}{k}"

    def add(self, blas: str, *, name: Optional[str] = None,
            out=None, window_size: Optional[int] = None,
            vector_width: Optional[int] = None,
            placement: Optional[Mapping] = None, **bindings):
        """Append one routine instance. Keyword bindings map the
        routine's scalar and input-port names to values (see module
        docstring); `out` aliases outputs to public names."""
        if self.is_loop:
            raise BuilderError(
                "cannot add dataflow routines to a loop builder (this "
                "builder already has operands/iterate)")
        try:
            rdef = R.get(blas)
        except KeyError as e:
            raise BuilderError(str(e)) from None
        if name is None:
            name = self._auto_name(blas)
        if name in self._by_name:
            raise BuilderError(
                f"duplicate routine name {name!r} (routine names must "
                f"be unique within a program)")

        # validate everything first, mutate nothing until the end —
        # a failed add() must leave the builder exactly as it was
        entry: dict = {"blas": blas, "name": name}
        scalars: dict = {}
        inputs: dict = {}
        pending_edges: list = []        # (src Port, dst port name)
        for k, v in bindings.items():
            if k in rdef.scalars:
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    scalars[k] = {"value": float(v)}
                elif isinstance(v, InputRef):
                    scalars[k] = {"input": v.name}
                elif isinstance(v, str):
                    scalars[k] = {"input": v}
                elif isinstance(v, Port):
                    raise BuilderError(
                        f"{name}.{k}: a routine output cannot feed a "
                        f"scalar stream (scalar outputs leave the "
                        f"program; recompose with a let stage in a "
                        f"loop program instead)")
                else:
                    raise BuilderError(
                        f"{name}.{k}: scalar binding must be a number, "
                        f"input name, or b.input(...), got {v!r}")
            elif k in rdef.inputs:
                if isinstance(v, Port):
                    self._check_port(v, name, k)
                    pending_edges.append((v, k))
                elif isinstance(v, InputRef):
                    inputs[k] = v.name
                elif isinstance(v, str):
                    inputs[k] = v
                else:
                    raise BuilderError(
                        f"{name}.{k}: input binding must be a public "
                        f"input name or a Port from an earlier routine "
                        f"call, got {v!r}")
            else:
                raise BuilderError(
                    f"{name}: routine {blas!r} has no port or scalar "
                    f"{k!r}; scalars: {list(rdef.scalars)}, inputs: "
                    f"{list(rdef.inputs)}")
        if scalars:
            entry["scalars"] = scalars
        if inputs:
            entry["inputs"] = inputs

        out_ports = list(rdef.outputs)
        if out is not None:
            if isinstance(out, str):
                if len(out_ports) != 1:
                    raise BuilderError(
                        f"{name}: out=str needs a single-output "
                        f"routine; {blas!r} has outputs {out_ports} — "
                        f"pass a dict port -> public name")
                entry["outputs"] = {out_ports[0]: out}
            elif isinstance(out, Mapping):
                for port in out:
                    if port not in rdef.outputs:
                        raise BuilderError(
                            f"{name}: routine {blas!r} has no output "
                            f"port {port!r}; outputs: {out_ports}")
                entry["outputs"] = dict(out)
            else:
                raise BuilderError(
                    f"{name}: out must be a public name or a dict "
                    f"port -> public name, got {out!r}")
        if window_size is not None:
            entry["window_size"] = int(window_size)
        if vector_width is not None:
            entry["vector_width"] = int(vector_width)
        if placement is not None:
            entry["placement"] = {k: list(v)
                                  for k, v in dict(placement).items()}

        # validation done — commit the routine and its edges atomically
        for src, dst_port in pending_edges:
            self._connect(src, name, dst_port)
        self._routines.append(entry)
        self._by_name[name] = entry
        if len(out_ports) == 1:
            return Port(self, name, out_ports[0])
        return {p: Port(self, name, p) for p in out_ports}

    def _check_port(self, src: Port, dst_name: str, dst_port: str):
        if src.builder is not self:
            raise BuilderError(
                f"{dst_name}.{dst_port}: Port {src!r} belongs to a "
                f"different builder")
        if src.routine not in self._by_name:
            raise BuilderError(
                f"{dst_name}.{dst_port}: dangling port {src!r} — its "
                f"routine is not part of this program")

    def _connect(self, src: Port, dst_name: str, dst_port: str):
        conns = self._by_name[src.routine].setdefault("connections", {})
        target = f"{dst_name}.{dst_port}"
        prev = conns.get(src.port)
        if prev is None:
            conns[src.port] = target
        elif isinstance(prev, str):
            conns[src.port] = [prev, target]
        else:
            prev.append(target)

    # -- loop construction -----------------------------------------------

    def _want_loop(self, what: str):
        if self._routines:
            raise BuilderError(
                f"cannot add {what} to a dataflow builder (this "
                f"builder already has routine calls; loop bodies are "
                f"nested programs — see blas.stage)")

    def operand(self, name: str, kind: str) -> "ProgramBuilder":
        """Declare a loop operand (`vector` | `matrix` | `scalar`)."""
        self._want_loop("operands")
        for knob in ("window_size", "vector_width"):
            if knob in self._top:
                raise BuilderError(
                    f"{knob} is a dataflow-program knob and loop specs "
                    f"reject it; set it on the stage programs instead")
        if kind not in spec_mod.OPERAND_KINDS:
            raise BuilderError(
                f"operand {name!r}: unknown kind {kind!r}; expected "
                f"one of {spec_mod.OPERAND_KINDS}")
        if not isinstance(name, str) or not spec_mod._IDENT.match(name):
            raise BuilderError(
                f"operand name must be an identifier, got {name!r}")
        if name in self._operands:
            raise BuilderError(f"duplicate operand {name!r}")
        self._operands[name] = kind
        return self

    def setup(self, stage_raw, inputs: Optional[Mapping] = None,
              outputs: Optional[Mapping] = None) -> "ProgramBuilder":
        """Append a setup stage: a raw stage dict, a `blas.let(...)`,
        or a program (dict / ProgramBuilder, optionally with
        inputs/outputs rebinding)."""
        self._want_loop("setup stages")
        self._setup.append(_as_stage(stage_raw, inputs, outputs))
        return self

    def state(self, name: str, init=None, *, kind: Optional[str] = None,
              slots: Optional[int] = None, of: Optional[str] = None,
              len: Optional[int] = None, like: Optional[str] = None,
              slot0: Optional[str] = None,
              from_: Optional[str] = None) -> StateRef:
        """Declare one loop state field ahead of `iterate()`; returns
        a StateRef handle. Regular fields take `init=` (an expression
        or bare env name); stacks take `slots=`/`of=` plus one of
        `len=`/`like=`/`slot0=`/`from_=` (see docs/spec.md)."""
        self._want_loop("state fields")
        if not isinstance(name, str) or not spec_mod._IDENT.match(name):
            raise BuilderError(
                f"state name must be an identifier, got {name!r}")
        if name in self._state:
            raise BuilderError(f"duplicate state field {name!r}")
        is_stack = kind == "stack" or slots is not None
        if is_stack:
            if init is not None:
                raise BuilderError(
                    f"state {name!r}: stacks preallocate — use "
                    f"slot0= (seed slot 0) or from_= (adopt a "
                    f"buffer), not init=")
            if slot0 is not None and from_ is not None:
                raise BuilderError(
                    f"state {name!r}: slot0= and from_= conflict "
                    f"(from_ adopts a whole buffer, slot0 seeds a "
                    f"zeros one)")
            field: dict = {"kind": "stack", "slots": slots, "of": of}
            if len is not None:
                field["len"] = len
            if like is not None:
                field["like"] = _name_of(like)
            if slot0 is not None:
                field["init"] = {"slot0": _name_of(slot0)}
            if from_ is not None:
                field["init"] = {"from": _name_of(from_)}
        else:
            if init is None:
                raise BuilderError(
                    f"state {name!r}: needs init= (or slots=/of= for "
                    f"a stack)")
            field = {"init": init}
            if kind is not None:
                field["kind"] = kind
        self._state[name] = field
        return StateRef(name)

    def feedback(self, **edges) -> "ProgramBuilder":
        """Accumulate feedback edges (`b.feedback(x="x_next")`) for a
        later `iterate()` call that omits `feedback=`."""
        self._want_loop("feedback edges")
        for fname, src in edges.items():
            self._feedback[fname] = _name_of(src)
        return self

    def cond(self, pred: str, then, orelse=None) -> dict:
        """Build a conditional stage dict for a body list — sugar for
        module-level `blas.cond`."""
        return cond(pred, then, orelse)

    def inner_loop(self, **kw) -> dict:
        """Build a nested-iterate stage dict for a body list — sugar
        for module-level `blas.inner_loop`."""
        return inner_loop(**kw)

    def iterate(self, *, state: Optional[Mapping] = None, body,
                feedback: Optional[Mapping] = None,
                stop: Mapping, solution: Optional[Mapping] = None,
                guards: Optional[Mapping] = None
                ) -> "ProgramBuilder":
        """Declare the loop: state fields with init expressions, the
        staged body, feedback edges, the `while` stop rule, the
        solution mapping, and optional in-loop `guards` (nonfinite /
        breakdown / divergence / stagnation predicates — see
        docs/robustness.md). `state`/`feedback` default to what
        `b.state(...)` / `b.feedback(...)` accumulated. See
        docs/spec.md for the JSON semantics."""
        self._want_loop("an iterate section")
        if self._iterate is not None:
            raise BuilderError("iterate() may only be called once")
        if state is None:
            state_map = dict(self._state)
        elif self._state:
            raise BuilderError(
                "state was declared via b.state(...) AND passed to "
                "iterate(state=...); use one or the other")
        else:
            state_map = {n: _state_entry(v)
                         for n, v in dict(state).items()}
        if not state_map:
            raise BuilderError(
                "iterate() needs state fields (state= or prior "
                "b.state(...) calls)")
        if feedback is None:
            feedback_map = dict(self._feedback)
        elif self._feedback:
            raise BuilderError(
                "feedback was declared via b.feedback(...) AND passed "
                "to iterate(feedback=...); use one or the other")
        else:
            feedback_map = {k: _name_of(v)
                            for k, v in dict(feedback).items()}
        it = {
            "state": {n: (dict(v) if isinstance(v, Mapping)
                          else {"init": v})
                      for n, v in state_map.items()},
            "body": [_as_stage(s) for s in body],
            "feedback": feedback_map,
            "while": dict(stop),
        }
        if guards is not None:
            it["guards"] = copy.deepcopy(dict(guards))
        if solution is not None:
            it["solution"] = {k: _name_of(v)
                              for k, v in dict(solution).items()}
        self._iterate = it
        return self

    # -- serialization ---------------------------------------------------

    def to_spec(self) -> dict:
        """The raw JSON-able spec dict (deep copy — mutating it cannot
        skew the builder, and vice versa)."""
        raw = dict(self._top)
        if self.is_loop:
            if self._iterate is None:
                raise BuilderError(
                    "loop builder has operands/state but no "
                    "iterate() section")
            raw["operands"] = dict(self._operands)
            if self._setup:
                raw["setup"] = copy.deepcopy(self._setup)
            raw["iterate"] = copy.deepcopy(self._iterate)
        else:
            raw["routines"] = copy.deepcopy(self._routines)
        return raw

    def build(self) -> Union[ProgramSpec, LoopSpec]:
        """Parse-validate the accumulated spec (raises SpecError with
        the standard spec diagnostics) and return the parsed form."""
        raw = self.to_spec()
        if spec_mod.is_loop_spec(raw):
            return spec_mod.parse_loop(raw)
        return spec_mod.parse(raw)

    def digest(self) -> str:
        """Content digest of the built spec — the program-cache key."""
        return lowering.spec_digest(self.to_spec())

    # -- reconstruction --------------------------------------------------

    @classmethod
    def from_spec(cls, raw) -> "ProgramBuilder":
        """Reconstruct a builder from raw JSON (dict / JSON string /
        path), a parsed ProgramSpec/LoopSpec, or another builder.

        Raw input is preserved verbatim after validation, so
        `from_spec(x).to_spec()` is digest-identical to `x`."""
        if isinstance(raw, ProgramBuilder):
            raw = raw.to_spec()
        elif isinstance(raw, ProgramSpec):
            raw = spec_mod.unparse(raw)
        elif isinstance(raw, LoopSpec):
            raw = spec_mod.unparse_loop(raw)
        elif isinstance(raw, pathlib.Path):
            raw = json.loads(raw.read_text())
        elif isinstance(raw, str):
            raw = json.loads(raw)
        if not isinstance(raw, Mapping):
            raise BuilderError(
                f"from_spec needs a spec mapping, JSON, path, parsed "
                f"spec, or builder; got {type(raw).__name__}")

        b = cls.__new__(cls)
        b._top = {}
        b._routines = []
        b._by_name = {}
        b._operands = {}
        b._setup = []
        b._state = {}
        b._feedback = {}
        b._iterate = None

        if spec_mod.is_loop_spec(raw):
            spec_mod.parse_loop(raw)   # full validation up front
            b._operands = copy.deepcopy(dict(raw["operands"]))
            b._setup = copy.deepcopy(list(raw.get("setup", [])))
            b._iterate = copy.deepcopy(dict(raw["iterate"]))
            skip = ("operands", "setup", "iterate")
        else:
            spec_mod.parse(raw)
            b._routines = copy.deepcopy(list(raw.get("routines", [])))
            b._by_name = {e.get("name", e.get("blas")): e
                          for e in b._routines}
            skip = ("routines",)
        # keep EVERY other top-level key (parse ignores unknown
        # dataflow-spec extras like annotations) so the round-trip
        # digest cannot drift from the input
        b._top = copy.deepcopy({k: v for k, v in raw.items()
                                if k not in skip})
        return b


_STAGE_TAGS = ("let", "program", "cond", "read", "store", "iterate")


def _as_stage(s, inputs: Optional[Mapping] = None,
              outputs: Optional[Mapping] = None) -> dict:
    """Normalize one loop-stage argument to its raw dict form."""
    if isinstance(s, ProgramBuilder):
        return stage(s, inputs, outputs)
    if isinstance(s, Mapping):
        if any(tag in s for tag in _STAGE_TAGS):
            if inputs or outputs:
                raise BuilderError(
                    "inputs/outputs rebinding is only valid with a "
                    "program, not a pre-built stage dict")
            return dict(s)
        return stage(s, inputs, outputs)   # bare program spec dict
    raise BuilderError(
        f"loop stage must be a stage dict, spec dict, let(...), "
        f"cond(...), read(...), store(...), inner_loop(...), or "
        f"ProgramBuilder, got {type(s).__name__}")


def program(name: Optional[str] = None, **kw) -> ProgramBuilder:
    """Entry point: `b = blas.program("axpydot")`."""
    return ProgramBuilder(name, **kw)
