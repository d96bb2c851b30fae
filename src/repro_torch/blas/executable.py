"""`blas.compile(...)` -> `Executable`: one handle over both program
kinds.

A fused dataflow spec lowers to a `core.runtime.Program`; a spec with
an `iterate` section lowers to a `solvers.LoopProgram`; a class-based
solver (BiCGStab, PowerIteration) can be wrapped too. Whichever is
underneath, the handle exposes:

    exe.run(**inputs)        -> Results (dataflow) / SolverResult (loop)
    exe.one(**inputs)        -> the single output / the solution vector
    exe.batched(**inputs)    -> one run per lane, outputs stacked
    exe.describe()           -> fusion-plan / stage report
    exe.cost_report(shapes)  -> roofline-model flops/bytes table
    exe.save(path)           -> canonical spec JSON
    blas.load(path)          -> compile it back

`compile` accepts raw JSON (dict / string / path), a ProgramBuilder, or
a parsed ProgramSpec/LoopSpec, and routes dataflow programs through the
digest-keyed lowering cache so recompiling the same spec is free. Every
program runs on the CUDA card unless compiled with `device="cpu"`.

Not ported yet, each raising NotImplementedError that names its
ROADMAP Queue 1 item: `profile` and `tune` and the tuning store behind
`tiles="auto"` (item 12: "auto" resolves to the kernels' default
tiles and writes nothing), `verify` (item 11: `compile(verify=)` is
accepted and does nothing) and the batched loop solve (item 17).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core import lowering, routines as R, spec as spec_mod
from repro_torch.core.runtime import Program, Results
from repro_torch.core.spec import CountRule, LoopSpec, ProgramSpec, SpecError
from repro_torch.solvers.driver import LoopProgram, SolverProgram, SolverResult

from .builder import ProgramBuilder

# Roofline constants of the card: an H100 SXM's HBM3 rate and its
# float32 rate outside the tensor cores (published figures, the same as
# chip_smoke.py's bounds)
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12

# the ROADMAP Queue 1 items of what is not ported yet
VERIFY = "ROADMAP Queue 1, item 11"
TUNING = "ROADMAP Queue 1, item 12"


# ---------------------------------------------------------------------------
# Cost model: shape propagation over the dataflow graph
# ---------------------------------------------------------------------------


def _norm_shape(s) -> tuple:
    if isinstance(s, int):
        return (s,)
    return tuple(int(d) for d in s)


def _out_shape(rdef, blas: str, kind: str, sh: Mapping) -> tuple:
    if kind == R.OUT_SCALAR:
        return ()
    if kind == R.OUT_VEC:
        if blas == "gemvt":                   # out follows Aᵀ's rows
            return (sh["A"][1],)
        if blas == "coldot":                  # one entry per column
            return (sh["x"][1],)
        mats = [p for p, k in rdef.inputs.items() if k == R.MAT]
        if mats:
            return (sh[mats[0]][0],)
        vecs = [p for p, k in rdef.inputs.items() if k == R.VEC]
        return sh[vecs[0]]
    # OUT_MAT
    if blas == "gemm":
        return (sh["A"][0], sh["B"][1])
    if blas == "transpose":
        return (sh["A"][1], sh["A"][0])
    mats = [p for p, k in rdef.inputs.items() if k == R.MAT]
    return sh[mats[0]]


def _program_cost(ir, shapes: Mapping, scope: str = ""):
    """Per-routine (flops, bytes) rows for one lowered program, plus
    fused-group HBM savings, matrix-operand bytes, public-output shapes
    and per-fusion-group rows. `matrix_bytes` is the part of the naive
    traffic owed to MAT-kind operands — identical in fused and unfused
    schedules (the matrix is streamed once either way), so reports can
    separate it from the vector handoff traffic that fusion removes."""
    port_shape = {}
    for pi in ir.io.inputs:
        if pi.kind == "scalar":
            continue
        if pi.name not in shapes:
            raise ValueError(
                f"cost_report: missing shape for program input "
                f"{pi.name!r} (a {pi.kind})")
        port_shape[(pi.routine, pi.port)] = _norm_shape(shapes[pi.name])

    dtype_bytes = ir.spec.dtype.itemsize
    rows, out_port_shape, matrix_bytes = [], {}, 0
    by_name = {}
    for name in ir.graph.order:
        r = ir.graph.nodes[name]
        rdef = r.rdef
        sh = {port: port_shape[(name, port)] for port in rdef.inputs}
        flops, nbytes = rdef.cost(sh) if rdef.cost else (0, 0)
        rows.append((f"{scope}{name}", r.blas, int(flops), int(nbytes)))
        by_name[name] = (int(flops), int(nbytes))
        vec_elems = sum(
            int(np.prod(sh[p], dtype=np.int64))
            for p, k in rdef.inputs.items() if k == R.VEC)
        for port, kind in rdef.outputs.items():
            oshape = _out_shape(rdef, r.blas, kind, sh)
            out_port_shape[(name, port)] = oshape
            if kind == R.OUT_VEC:
                vec_elems += int(np.prod(oshape, dtype=np.int64))
            for e in ir.graph.consumers_of(name, port):
                port_shape[(e.dst, e.dst_port)] = oshape
        # whatever the cost model charges beyond the vector windows is
        # matrix traffic (symv charges half its matrix, gemm all of it)
        matrix_bytes += max(0, int(nbytes) - vec_elems * dtype_bytes)

    # On-chip edges inside a fused group never round-trip through HBM.
    # Two conventions, both reported:
    #   savings       — one write + one read per internal edge (the
    #                   handoff round-trip kept on-chip)
    #   savings_exact — physical bytes the fused kernel does not move:
    #                   the read per internal consumer, plus the write
    #                   ONLY when the source port is not also a program
    #                   output / externally consumed.
    ext_pub = {(pi.routine, pi.port): pi.name
               for pi in ir.io.inputs if pi.kind != "scalar"}
    savings = savings_exact = 0
    group_rows = []
    for gi, g in enumerate(ir.groups or ()):
        members = set(g.nodes)
        g_savings = g_exact = 0
        if g.fused and len(g.nodes) >= 2:
            for name in g.nodes:
                r = ir.graph.nodes[name]
                for port in r.rdef.outputs:
                    consumers = ir.graph.consumers_of(name, port)
                    internal = [e for e in consumers if e.dst in members]
                    if not internal:
                        continue
                    elems = int(np.prod(out_port_shape[(name, port)],
                                        dtype=np.int64))
                    port_bytes = elems * dtype_bytes
                    g_savings += 2 * port_bytes * len(internal)
                    g_exact += port_bytes * len(internal)
                    external = [e for e in consumers
                                if e.dst not in members]
                    if not external and port not in r.output_aliases:
                        g_exact += port_bytes
        # Gemm-anchored tile groups route matrices across group-internal
        # edges, which the naive matrix accounting double-counts: a
        # member MAT port fed on-chip never reads HBM, and two member MAT
        # ports bound to the same public input are one stream.
        if g.fused and g.anchor is not None and \
                R.OUT_MAT in set(ir.graph.nodes[g.anchor]
                                 .rdef.outputs.values()):
            seen_pub = set()
            for name in g.nodes:
                r = ir.graph.nodes[name]
                for port, kind in r.rdef.inputs.items():
                    if kind != R.MAT:
                        continue
                    pbytes = int(np.prod(port_shape[(name, port)],
                                         dtype=np.int64)) * dtype_bytes
                    e = ir.graph.producer_of(name, port)
                    if e is not None and e.src in members:
                        matrix_bytes -= pbytes
                        continue
                    pub = ext_pub.get((name, port))
                    if pub is None:
                        continue
                    if pub in seen_pub:
                        matrix_bytes -= pbytes
                        g_savings += pbytes
                        g_exact += pbytes
                    else:
                        seen_pub.add(pub)
        savings += g_savings
        savings_exact += g_exact
        group_rows.append({
            "program": ir.spec.name, "group": gi,
            "routines": list(g.nodes), "anchor": g.anchor,
            "fused": g.fused,
            "flops": sum(by_name[n][0] for n in g.nodes),
            "bytes_naive": sum(by_name[n][1] for n in g.nodes),
            "savings": g_savings, "savings_exact": g_exact,
        })
    out_shapes = {po.name: out_port_shape[(po.routine, po.port)]
                  for po in ir.io.outputs}
    return (rows, (savings, savings_exact), matrix_bytes, out_shapes,
            group_rows)


@dataclasses.dataclass
class CostReport:
    """Roofline-model accounting for one executable, from the registry
    cost models (`core.routines.RoutineDef.cost`), with times from the
    card's rates (`PEAK_FLOPS`, `HBM_BW`). For loop programs the totals
    describe ONE body iteration; setup rows are listed but kept out of
    the per-iteration totals."""
    program: str
    mode: str
    kind: str                       # "dataflow" | "loop"
    rows: tuple                     # (label, blas, flops, bytes)
    flops: int                      # per call / per iteration
    bytes_naive: int                # per-routine HBM traffic
    fused_savings: int              # handoff round-trips kept on-chip
    matrix_bytes: int = 0           # MAT-operand share of bytes_naive
    # physical bytes not moved: unlike fused_savings, a public
    # intermediate's write (still issued once) is not credited
    fused_savings_exact: int = 0

    @property
    def bytes(self) -> int:
        if self.mode == "dataflow":
            return self.bytes_naive - self.fused_savings
        return self.bytes_naive

    @property
    def vector_bytes_naive(self) -> int:
        """The vector-handoff share of the naive traffic — the part
        dataflow fusion can remove (the matrix stream is identical in
        both schedules)."""
        return self.bytes_naive - self.matrix_bytes

    @property
    def vector_bytes(self) -> int:
        if self.mode == "dataflow":
            return self.vector_bytes_naive - self.fused_savings
        return self.vector_bytes_naive

    @property
    def bytes_exact(self) -> int:
        """Physical traffic: naive minus only the bytes the fused
        kernels genuinely do not move."""
        if self.mode == "dataflow":
            return self.bytes_naive - self.fused_savings_exact
        return self.bytes_naive

    @property
    def vector_reduction(self) -> float:
        """Fraction of the avoidable (vector) traffic whose handoff
        round-trips fusion keeps on-chip in dataflow mode."""
        if not self.vector_bytes_naive or self.mode != "dataflow":
            return 0.0
        return self.fused_savings / self.vector_bytes_naive

    @property
    def vector_reduction_exact(self) -> float:
        """Fraction of the avoidable (vector) traffic physically not
        moved — public intermediates still pay their one write."""
        if not self.vector_bytes_naive or self.mode != "dataflow":
            return 0.0
        return self.fused_savings_exact / self.vector_bytes_naive

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def __str__(self):
        unit = "iteration" if self.kind == "loop" else "call"
        lines = [f"cost report: {self.program!r} mode={self.mode} "
                 f"(per {unit})"]
        for label, blas, flops, nbytes in self.rows:
            lines.append(f"  {label:<28} {blas:<8} "
                         f"{flops:>12,} flop {nbytes:>12,} B")
        lines.append(
            f"  total: {self.flops:,} flop, {self.bytes:,} B HBM "
            f"({self.fused_savings:,} B of handoff round-trips kept "
            f"on-chip by fusion; {self.fused_savings_exact:,} B "
            f"physically not moved)")
        lines.append(
            f"  vector traffic: {self.vector_bytes:,} B of "
            f"{self.vector_bytes_naive:,} B naive "
            f"({100 * self.vector_reduction:.1f}% of round-trips "
            f"fused away, {100 * self.vector_reduction_exact:.1f}% "
            f"physical; matrix stream {self.matrix_bytes:,} B is "
            f"schedule-invariant)")
        lines.append(
            f"  arithmetic intensity {self.intensity:.3f} flop/B -> "
            f"{self.bound}-bound "
            f"(t_compute {self.t_compute:.3e}s, "
            f"t_memory {self.t_memory:.3e}s on an H100 SXM)")
        return "\n".join(lines)


def _loop_cost(lir, shapes: Mapping):
    """Shape-propagating cost walk over a loop program's setup and body
    stages: (setup rows, body rows, body savings, body exact savings,
    body matrix bytes). A `cond` charges its costlier branch; a nested
    count loop charges its body times a literal count (a dynamic count
    once), a metric loop its max_iters."""
    env = {}
    for oname, okind in lir.lspec.operands.items():
        if okind == "scalar":
            env[oname] = ()
        else:
            if oname not in shapes:
                raise ValueError(
                    f"cost_report: missing shape for operand "
                    f"{oname!r} (a {okind})")
            env[oname] = _norm_shape(shapes[oname])

    def field_shape(f, env):
        if not f.is_stack:
            bare = f.init.bare_name
            return env[bare] if bare is not None else ()
        if f.source is not None:
            src = env[f.source]
            return (f.slots,) + tuple(src[1:])
        if f.of == "scalar":
            return (f.slots,)
        if f.length is not None:
            return (f.slots, f.length)
        proto = f.like if f.like is not None else f.slot0
        return (f.slots,) + tuple(env[proto])

    def trip_count(stop):
        if isinstance(stop, CountRule):
            return (int(stop.count.ast[1])
                    if stop.count.ast[0] == "num" else 1)
        return stop.max_iters

    def walk(stages, scope, env):
        rows, savings, exact, mat_bytes = [], 0, 0, 0
        for cs in stages:
            if cs.tag == "let":
                for n, e in cs.stage.bindings:
                    bare = e.bare_name
                    env[n] = env[bare] if bare is not None else ()
            elif cs.tag == "read":
                st = cs.stage
                env[st.name] = tuple(env[st.source][1:])
            elif cs.tag == "store":
                pass
            elif cs.tag == "cond":
                results = []
                for label, sub in (("then", cs.then), ("else", cs.orelse)):
                    benv = dict(env)
                    out = walk(sub, f"{scope}cond.{label}.", benv)
                    results.append((out, benv))
                (t_out, t_env), (e_out, e_env) = results
                out, benv = ((e_out, e_env)
                             if sum(r[3] for r in e_out[0])
                             >= sum(r[3] for r in t_out[0])
                             else (t_out, t_env))
                rows.extend(out[0])
                savings += out[1]
                exact += out[2]
                mat_bytes += out[3]
                for n in cs.produced:
                    env[n] = benv[n]
            elif cs.tag == "loop":
                st = cs.stage
                benv = dict(env)
                if st.counter is not None:
                    benv[st.counter] = ()
                for f in st.state:
                    benv[f.name] = field_shape(f, benv)
                count = trip_count(st.stop)
                r, s, se, mb = walk(cs.body, f"{scope}loop.", benv)
                rows.extend((f"{label} x{count}", blas, fl * count,
                             by * count) for label, blas, fl, by in r)
                savings += s * count
                exact += se * count
                mat_bytes += mb * count
                for outer_name, field in st.yields.items():
                    env[outer_name] = benv[field]
            else:
                inner = {pub: env[src] for pub, src in cs.inputs.items()}
                r, (s, se), mb, outs, _ = _program_cost(
                    cs.ir, inner, scope=f"{scope}{cs.ir.spec.name}.")
                rows.extend(r)
                savings += s
                exact += se
                mat_bytes += mb
                for pub, dst in cs.outputs.items():
                    env[dst] = outs[pub]
        return rows, savings, exact, mat_bytes

    setup_rows, _, _, _ = walk(lir.setup, "setup:", env)
    # state fields adopt their init value's shape (bare names), stacks
    # preallocate (slots, ...) buffers, composite expressions are
    # scalars; the driver-bound threshold rides along for cond predicates
    for f in lir.lspec.state:
        env[f.name] = field_shape(f, env)
    env["threshold"] = ()
    body_rows, body_savings, body_exact, body_mat = walk(lir.body, "body:",
                                                        env)
    return setup_rows, body_rows, body_savings, body_exact, body_mat


def _lanes(inputs: Mapping, in_axes: Mapping) -> int:
    """The common size of the batched inputs' batch axes."""
    sizes = {name: inputs[name].shape[axis]
             for name, axis in in_axes.items()
             if axis is not None and name in inputs}
    if not sizes:
        raise ValueError("batched() needs at least one input with a batch "
                         "axis (every axis is None)")
    if len(set(sizes.values())) != 1:
        raise ValueError(f"batched(): inputs disagree on the batch size: "
                         f"{sizes}")
    return next(iter(sizes.values()))


# ---------------------------------------------------------------------------
# Executable
# ---------------------------------------------------------------------------


class Executable:
    """One handle over a compiled dataflow Program, a JSON loop program,
    or a wrapped class-based solver."""

    def __init__(self, impl, raw: Optional[Mapping], kind: str, mode: str,
                 device: torch.device, fuse: Optional[bool] = None,
                 anchor: Optional[bool] = None, tiles="auto"):
        self._impl = impl
        self._raw = raw
        self.kind = kind            # "dataflow" | "loop"
        self.mode = mode
        self.device = device
        self.fuse = fuse
        self.anchor = anchor
        self.tiles = tiles          # the compile-time tiles request

    # -- construction (see also module-level compile/load) ---------------

    @classmethod
    def from_solver(cls, solver: SolverProgram,
                    raw: Optional[Mapping] = None) -> "Executable":
        """Wrap a class-based SolverProgram (logic beyond the loop-spec
        grammar, e.g. the Rayleigh-quotient metric) behind the same
        handle."""
        return cls(impl=solver, raw=raw, kind="loop", mode=solver.mode,
                   device=solver.device)

    # -- introspection ---------------------------------------------------

    @property
    def name(self) -> str:
        if isinstance(self._impl, Program):
            return self._impl.spec.name
        return self._impl.name

    @property
    def spec(self) -> Optional[Mapping]:
        """The canonical raw spec dict (None for wrapped class-based
        solvers, which have no JSON form)."""
        return self._raw

    @property
    def input_names(self):
        if self.kind == "dataflow":
            return list(self._impl.input_names)
        if isinstance(self._impl, LoopProgram):
            return sorted(self._impl.lir.lspec.operands)
        return None    # class-based solver: see its solve() signature

    @property
    def output_names(self):
        if self.kind == "dataflow":
            return list(self._impl.output_names)
        if isinstance(self._impl, LoopProgram):
            return sorted(self._impl.lir.lspec.solution)
        return ["x"]

    @property
    def trace_count(self) -> Optional[int]:
        """How many times a loop program's solve has been assembled from
        its compiled stage programs: 1 however many solves ran. None for
        dataflow programs."""
        return getattr(self._impl, "trace_count", None)

    def builder(self) -> ProgramBuilder:
        """Reconstruct a ProgramBuilder from this executable's spec."""
        if self._raw is None:
            raise ValueError(
                f"{self.name!r} wraps a class-based solver with no "
                f"JSON spec; there is nothing to rebuild")
        return ProgramBuilder.from_spec(self._raw)

    def describe(self) -> str:
        return self._impl.describe()

    def verify(self):
        """The reference re-runs its static analyzer over the spec; the
        port's analyzer is not written yet. Raises ValueError for
        wrapped class-based solvers (no JSON spec to analyze)."""
        if self._raw is None:
            raise ValueError(
                f"{self.name!r} wraps a class-based solver with no "
                f"JSON spec; there is nothing to verify")
        raise NotImplementedError(
            f"the static analyzer is not ported yet ({VERIFY})")

    def __repr__(self):
        return (f"Executable({self.name!r}, kind={self.kind}, "
                f"mode={self.mode}, device={self.device})")

    # -- execution -------------------------------------------------------

    def run(self, *, tol: Optional[float] = None, **inputs
            ) -> Union[Results, SolverResult]:
        """Execute. Dataflow: keyword inputs are the program's public
        inputs, returns a Results mapping. Loop: keyword inputs are the
        declared operands (plus optional `tol`), returns a SolverResult.

        `tol` (and `axes` on batched()) are reserved keywords of this
        handle; a spec that names a public input or operand `tol` must
        run through `Program`/`LoopProgram` directly."""
        if self.kind == "dataflow":
            if tol is not None:
                raise TypeError(
                    "tol is a loop-program knob; this is a dataflow "
                    "program")
            return self._impl(**inputs)
        if isinstance(self._impl, LoopProgram):
            return self._impl.solve(tol=tol, **inputs)
        if tol is not None:
            inputs["tol"] = tol
        return self._impl.solve(**inputs)

    __call__ = run

    def one(self, *, tol: Optional[float] = None, **inputs) -> torch.Tensor:
        """Single-result sugar: the lone output of a one-output dataflow
        program, or the solution vector of a loop program."""
        out = self.run(tol=tol, **inputs)
        if isinstance(out, Results):
            return out.one()
        return out.x

    def batched(self, *, tol: Optional[float] = None,
                axes: Optional[Mapping] = None, **inputs):
        """Run over a leading batch axis. Convention (overridable via
        `axes`): vector inputs batch on axis 0, matrices and scalars
        broadcast. A dataflow program runs once per lane and each output
        is stacked along a new axis 0, as the reference's `jax.vmap`
        returns it; a loop program goes to `LoopProgram.batched`."""
        if self.kind != "dataflow":
            if isinstance(self._impl, LoopProgram):
                return self._impl.batched(tol=tol, axes=axes, **inputs)
            raise TypeError(
                f"{self.name!r}: batched() on a class-based solver "
                f"goes through its solve_batched() method")
        if tol is not None:
            raise TypeError(
                "tol is a loop-program knob; this is a dataflow program")
        kinds = self._impl.ir.io.input_kinds
        unknown = sorted(set(inputs) - set(kinds))
        if unknown:
            raise ValueError(
                f"{self.name!r}: unknown inputs {unknown}; declared: "
                f"{sorted(kinds)}")
        in_axes = {n: (0 if kinds[n] == "vector" else None) for n in kinds}
        if axes:
            unknown = sorted(set(axes) - set(in_axes))
            if unknown:
                raise ValueError(
                    f"{self.name!r}: axes for unknown inputs {unknown}")
            in_axes.update(axes)
        outs = []
        for lane in range(_lanes(inputs, in_axes)):
            lane_inputs = {
                n: (v if in_axes.get(n) is None else v.select(in_axes[n],
                                                              lane))
                for n, v in inputs.items()}
            outs.append(self._impl(**lane_inputs))
        return Results({k: torch.stack([o[k] for o in outs])
                        for k in outs[0]})

    # -- analysis --------------------------------------------------------

    def cost_report(self, shapes: Mapping) -> CostReport:
        """Roofline-model cost from the registry cost models. `shapes`
        maps public input / operand names to shape tuples (ints are
        one-element vector shapes; scalars may be omitted)."""
        if self.kind == "dataflow":
            rows, (savings, exact), mat_bytes, _, _ = _program_cost(
                self._impl.ir, shapes)
            return CostReport(program=self.name, mode=self.mode,
                              kind="dataflow", rows=tuple(rows),
                              flops=sum(r[2] for r in rows),
                              bytes_naive=sum(r[3] for r in rows),
                              fused_savings=savings,
                              fused_savings_exact=exact,
                              matrix_bytes=mat_bytes)
        if not isinstance(self._impl, LoopProgram):
            raise TypeError(
                f"{self.name!r}: cost_report needs a spec-described "
                f"program; class-based solvers carry no registry cost "
                f"model")
        (setup_rows, body_rows, body_savings, body_exact,
         body_mat) = _loop_cost(self._impl.lir, shapes)
        return CostReport(program=self.name, mode=self.mode, kind="loop",
                          rows=tuple(setup_rows + body_rows),
                          flops=sum(r[2] for r in body_rows),
                          bytes_naive=sum(r[3] for r in body_rows),
                          fused_savings=body_savings,
                          fused_savings_exact=body_exact,
                          matrix_bytes=body_mat)

    def profile(self, shapes: Mapping, *, iters: int = 20):
        """The reference joins measured per-kernel time against the cost
        model; the port's drift report is not written yet."""
        raise NotImplementedError(
            f"Executable.profile is not ported yet ({TUNING}); "
            f"cost_report() gives the model side")

    def tune(self, shapes: Mapping, *, budget: Optional[int] = None,
             iters: int = 3) -> "Executable":
        """The reference sweeps tile candidates into a tuning store; the
        port runs its kernels' default tiles."""
        raise NotImplementedError(
            f"Executable.tune is not ported yet ({TUNING}); the port "
            f"runs its kernels' default tiles")

    # -- persistence -----------------------------------------------------

    def save(self, path) -> pathlib.Path:
        """Write the canonical spec JSON. `blas.load(path)` (or any other
        entry point — it is a plain spec file) compiles it back."""
        if self._raw is None:
            raise ValueError(
                f"{self.name!r} wraps a class-based solver with no "
                f"canonical JSON form")
        path = pathlib.Path(path)
        # insertion order is semantic for `let` stages (bindings are
        # evaluated in order), so keys are written as-is, not sorted
        path.write_text(json.dumps(self._raw, indent=2) + "\n")
        return path


# ---------------------------------------------------------------------------
# compile / load
# ---------------------------------------------------------------------------


def _to_raw(obj) -> Mapping:
    # only the parsed-spec branches are local; everything else (dict /
    # JSON string / path / to_spec-protocol builders) normalizes through
    # the same helper the lowering layer uses
    if isinstance(obj, ProgramSpec):
        return spec_mod.unparse(obj)
    if isinstance(obj, LoopSpec):
        return spec_mod.unparse_loop(obj)
    try:
        return lowering._canonical_raw(obj)
    except SpecError:
        raise SpecError(
            f"compile() needs a spec dict, JSON string, path, "
            f"ProgramBuilder, or parsed spec; got "
            f"{type(obj).__name__}") from None


def compile(spec_or_builder, *, mode: str = "dataflow",
            fuse: Optional[bool] = None, anchor: Optional[bool] = None,
            device=None, max_iters: Optional[int] = None, tiles="auto",
            verify: bool = True, fault=None) -> Executable:
    """The one front door: lower anything spec-shaped to an Executable.

    Dataflow specs go through the digest-keyed program cache
    (`core.lowering.compile_cached`); loop specs (an `iterate` section)
    lower to a generic LoopProgram whose stage programs hit the same
    cache. `fuse`/`anchor` (level-2 anchored fusion, default follows
    `fuse`) and `max_iters` apply to the respective kind only. `device`
    defaults to the CUDA card and raises when there is none.

    `tiles`: `"auto"` (the default) and `"default"` both run the
    kernels' default block shapes, and nothing is written: the tuning
    store `"auto"` consults in the reference is ROADMAP Queue 1, item
    12, and anything else raises as `lowering` does. `verify` is
    accepted and does nothing (the static analyzer is item 11).

    `fault` (a `guard.chaos.FaultPlan`) arms deterministic fault
    injection: the outputs of the programs it matches are corrupted.
    Faulted compiles bypass the clean lowering cache."""
    raw = _to_raw(spec_or_builder)
    # the handle keeps its own copy: later caller-side mutation of the
    # spec dict must not make save()/spec/builder() disagree with the
    # already-compiled program
    raw = copy.deepcopy(raw)
    lowered_tiles = "default" if tiles == "auto" else tiles
    if spec_mod.is_loop_spec(raw):
        if fuse is not None or anchor is not None:
            raise ValueError(
                "fuse/anchor apply to dataflow programs; loop-program "
                "stages fuse according to the mode")
        impl = LoopProgram(raw, mode=mode, max_iters=max_iters,
                           device=device, tiles=lowered_tiles,
                           verify=verify, fault=fault)
        return Executable(impl=impl, raw=raw, kind="loop", mode=mode,
                          device=impl.device, tiles=tiles)
    if max_iters is not None:
        raise ValueError(
            "max_iters applies to loop programs; this spec has no "
            "iterate section")
    ir = lowering.compile_cached(raw, mode=mode, fuse=fuse, anchor=anchor,
                                 device=device, tiles=lowered_tiles,
                                 verify=verify, fault=fault)
    return Executable(impl=Program.from_ir(ir), raw=raw, kind="dataflow",
                      mode=mode, device=ir.device, fuse=ir.fuse,
                      anchor=ir.anchor, tiles=tiles)


def load(path, **compile_kwargs) -> Executable:
    """Compile a spec JSON file saved by `Executable.save` (or written
    by hand — it is the ordinary spec format)."""
    return compile(pathlib.Path(path), **compile_kwargs)
