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

    exe.verify()             -> the static analyzer's full report
    exe.profile(shapes)      -> modeled-vs-measured drift per group
    exe.tune(shapes)         -> a new handle compiled with tuned tiles
"""
from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import lowering, routines as R, spec as spec_mod
from repro_torch.core.runtime import (Program, Results, _synth_matrix,
                                      _synth_vector)
from repro_torch.core.spec import CountRule, LoopSpec, ProgramSpec, SpecError
from repro_torch.solvers.driver import (LoopProgram, SolverProgram,
                                       SolverResult, lane_of, lanes)

from repro_torch.tune import store as tune_store

from .builder import ProgramBuilder

# Roofline constants of the card: an H100 SXM's HBM3 rate and its
# float32 rate outside the tensor cores (published figures, the same as
# chip_smoke.py's bounds)
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12


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


def _loop_cost(lir, shapes: Mapping, *, env_sink: Optional[dict] = None,
               group_sink: Optional[list] = None):
    """Shape-propagating cost walk over a loop program's setup and body
    stages: (setup rows, body rows, body savings, body exact savings,
    body matrix bytes). A `cond` charges its costlier branch; a nested
    count loop charges its body times a literal count (a dynamic count
    once), a metric loop its max_iters.

    `env_sink`, when given, receives the final name -> shape environment
    (operands, setup outputs, state fields, body outputs);
    `_tune_loop_stages` resolves stage ports fed by loop state with it.
    `group_sink`, when given, collects the per-fusion-group model rows
    of the top-level body program stages only (the stages `profile`
    times; work inside `cond` branches and nested loops is not
    matched), each with a `calls` count."""
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

    def walk(stages, scope, env, group_sink=None):
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
                r, (s, se), mb, outs, grows = _program_cost(
                    cs.ir, inner, scope=f"{scope}{cs.ir.spec.name}.")
                if group_sink is not None:
                    for gr in grows:
                        key = (gr["program"], gr["group"])
                        prev = next((g for g in group_sink
                                     if (g["program"], g["group"]) == key),
                                    None)
                        if prev is None:
                            group_sink.append({**gr, "calls": 1})
                        else:
                            prev["calls"] += 1
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
    body_rows, body_savings, body_exact, body_mat = walk(
        lir.body, "body:", env, group_sink=group_sink)
    if env_sink is not None:
        env_sink.update(env)
    return setup_rows, body_rows, body_savings, body_exact, body_mat


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
        """Re-run the static analyzer over this executable's spec and
        return the full `repro_torch.verify.Report`: warnings and infos
        included, which the compile-time gate (errors only) does not
        surface. Raises ValueError for wrapped class-based solvers (no
        JSON spec to analyze)."""
        if self._raw is None:
            raise ValueError(
                f"{self.name!r} wraps a class-based solver with no "
                f"JSON spec; there is nothing to verify")
        from repro_torch import verify as verify_mod

        return verify_mod.analyze(self._raw, mode=self.mode)

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
            # while recording, the root span of one call: the spans of
            # its groups and launches reach its id through their parents
            with obs.span_with("program.call"):
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
        returns it; a loop program goes to `LoopProgram.batched`, which
        runs its compiled solve once per lane."""
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
        outs = [self._impl(**lane_of(inputs, in_axes, lane))
                for lane in range(lanes(inputs, in_axes))]
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

    def profile(self, shapes: Mapping, *,
                iters: int = 20) -> "obs.DriftReport":
        """Run the program under instrumentation and join the measured
        time of each group against the roofline cost model: the
        modeled-vs-measured drift report (`obs.DriftReport`).

        `shapes` is the mapping `cost_report` takes. Operands are
        synthesized from a seed on the executable's device; one run
        builds every kernel (its records are dropped), then `iters`
        recorded runs are joined: each group's `kernel.group` span waits
        for the group's outputs, so on the card it times the group's
        launches and kernels, on the CPU its plain versions. A dataflow
        program times whole calls; a loop program times `iters` body
        steps (`SolverProgram._step`) with threshold 0, so every `cond`
        takes its costlier branch, the cost model's convention. Each
        row carries the group's modeled bytes (fusion savings applied in
        dataflow mode), its roofline time max(flops / PEAK_FLOPS, bytes
        / HBM_BW), the measured mean and their ratio `drift`.

        Recording goes to a scoped registry: it needs no `obs.enable()`
        and leaks nothing into the caller's recording."""
        iters = int(iters)
        if iters < 1:
            raise ValueError("profile: iters must be >= 1")

        def model_row(gr, calls):
            nbytes = gr["bytes_naive"] - (
                gr["savings"] if self.mode == "dataflow" else 0)
            return {"program": gr["program"], "group": gr["group"],
                    "routines": gr["routines"], "anchor": gr["anchor"],
                    "flops": gr["flops"], "bytes": nbytes,
                    "time_s": max(gr["flops"] / PEAK_FLOPS,
                                  nbytes / HBM_BW),
                    "calls": calls}

        if self.kind == "dataflow":
            ir = self._impl.ir
            _, _, _, _, grows = _program_cost(ir, shapes)
            model_rows = [model_row(g, 1) for g in grows]
            sizes = {}
            for pi in ir.io.inputs:
                if pi.name in shapes:
                    sizes[pi.name] = _norm_shape(shapes[pi.name])
                elif pi.kind == "scalar":
                    sizes[pi.name] = ()
            inputs = self._impl.synthetic_inputs(sizes)
            with obs.capture():     # the warm-up builds the kernels;
                out = ir.fn(dict(inputs))   # its records are dropped
                obs.block(out.values())
            with obs.capture() as reg:
                for _ in range(iters):
                    ir.fn(dict(inputs))
                records = list(reg.records)
            return obs.join_drift(self.name, self.mode, "dataflow",
                                  iters, model_rows, records)

        if not isinstance(self._impl, LoopProgram):
            raise TypeError(
                f"{self.name!r}: profile needs a spec-described "
                f"program; class-based solvers carry no registry cost "
                f"model to drift against")
        model_groups: list = []
        _loop_cost(self._impl.lir, shapes, group_sink=model_groups)
        model_rows = [model_row(g, g["calls"]) for g in model_groups]
        lir = self._impl.lir
        dtype = lir.lspec.dtype
        operands = {}
        for i, oname in enumerate(sorted(lir.lspec.operands)):
            okind = lir.lspec.operands[oname]
            if okind == "scalar":
                operands[oname] = torch.tensor(0.5, dtype=dtype,
                                               device=self.device)
                continue
            if oname not in shapes:
                raise ValueError(
                    f"profile: missing shape for operand {oname!r} "
                    f"(a {okind})")
            sh = _norm_shape(shapes[oname])
            if okind == "matrix":
                operands[oname] = _synth_matrix(sh[0], sh[1], dtype, i,
                                                self.device)
            else:
                operands[oname] = _synth_vector(sh[0], dtype, i,
                                                self.device)
        impl = self._impl
        # threshold 0: every cond takes its not-converged branch, the
        # full step, as the cost model charges the costlier branch
        threshold = torch.tensor(0.0, dtype=torch.float32,
                                 device=self.device)
        with obs.capture():         # setup and a warm-up step: records
            state, _, _ = impl._init_state(operands)    # dropped
            warm, _ = impl._step(operands, state, threshold)
            obs.block(warm.values())
        with obs.capture() as reg:
            for _ in range(iters):
                stepped, _ = impl._step(operands, state, threshold)
                obs.block(stepped.values())
            records = list(reg.records)
        return obs.join_drift(self.name, self.mode, "loop", iters,
                              model_rows, records)

    # -- autotuning ------------------------------------------------------

    def tune(self, shapes: Mapping, *, budget: Optional[int] = None,
             iters: int = 3) -> "Executable":
        """Sweep tile candidates for this program at the given operand
        shapes and return a **new** Executable compiled with the
        winners (this handle is untouched). Winners persist in the
        tuning store, so later `tiles="auto"` compiles, in this or any
        other process on the same device kind, pick them up. `budget`
        caps timed candidate measurements.

        Loop programs tune each distinct stage program of their setup
        and body, its shapes taken from the loop operands (and the cost
        walk's shape environment) by name."""
        from repro_torch.tune import autotuner

        if self._raw is None:
            raise ValueError(
                f"{self.name!r} wraps a class-based solver with no "
                f"JSON spec; there is nothing to re-lower with tuned "
                f"tiles")
        shapes = {k: v if isinstance(v, int) else _norm_shape(v)
                  for k, v in shapes.items()}
        if self.kind == "dataflow":
            reports = [autotuner.tune_program(
                self._raw, shapes, mode=self.mode, fuse=self.fuse,
                anchor=self.anchor, device=self.device, budget=budget,
                iters=iters)]
        else:
            reports = self._tune_loop_stages(shapes, budget=budget,
                                             iters=iters)
        tuned = compile(self._raw, mode=self.mode, fuse=self.fuse,
                        anchor=self.anchor, device=self.device,
                        max_iters=(self._impl.max_iters
                                   if self.kind == "loop" else None),
                        tiles="auto")
        tuned.tune_report = reports[0] if len(reports) == 1 else reports
        return tuned

    def _tune_loop_stages(self, shapes: Mapping, *, budget, iters):
        """Tune the distinct program stages of a loop (setup and body),
        each stage's input shapes resolved from the loop operand shapes
        through the stage's input bindings."""
        from repro_torch.tune import autotuner

        lir = self._impl.lir
        dim_of = {}
        for oname, okind in lir.lspec.operands.items():
            if okind == "scalar" or oname not in shapes:
                continue
            sh = shapes[oname]
            dim_of[oname] = sh if isinstance(sh, tuple) else (sh,)
        # the cost walk's shape environment also covers setup outputs
        # and state fields, so a stage port fed by loop state (block-CG's
        # (n, s) P panel) tunes, and keys its row, at its true shape
        try:
            env_shapes: dict = {}
            _loop_cost(lir, dict(shapes), env_sink=env_shapes)
            for name, sh in env_shapes.items():
                if isinstance(sh, tuple) and sh and name not in dim_of:
                    dim_of[name] = sh
        except Exception:
            pass   # operand-only resolution remains the fallback
        n_fallback = max(
            (sh[0] for sh in dim_of.values() if len(sh) == 1),
            default=max((sh[0] for sh in dim_of.values()), default=256))

        seen, reports = set(), []

        def visit(compiled):
            for st in compiled:
                if st.tag == "program":
                    if st.ir.digest in seen:
                        continue
                    seen.add(st.ir.digest)
                    st_shapes = {}
                    for pub, kind in st.ir.io.input_kinds.items():
                        env_name = st.inputs.get(pub, pub)
                        if kind == "scalar":
                            continue
                        sh = dim_of.get(env_name)
                        if sh is None:
                            sh = ((n_fallback, n_fallback)
                                  if kind == "matrix" else (n_fallback,))
                        elif kind == "matrix" and len(sh) == 1:
                            sh = (sh[0], sh[0])
                        st_shapes[pub] = sh
                    reports.append(autotuner.tune_program(
                        st.ir.raw, st_shapes, mode=self.mode,
                        device=self.device, budget=budget, iters=iters))
                elif st.tag == "cond":
                    visit(st.then)
                    visit(st.orelse)
                elif st.tag == "loop":
                    visit(st.body)

        visit(lir.setup)
        visit(lir.body)
        return reports

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

    `tiles` picks the kernels' plans: `"auto"` (the default) reads the
    persistent tuning table (`~/.cache/repro_torch`, or
    `REPRO_TORCH_CACHE_DIR`), where a cold table keeps the kernels'
    defaults and never measures; `"default"` skips the table; a
    `tune.TileConfig` or `TilePlan` applies explicitly. A dataflow
    compile with `"auto"` also persists a digest-keyed artifact (the
    spec and its resolved plan), so a later process resolves the
    program with one table lookup.

    `verify=True` (the default) runs the static analyzer first
    (`repro_torch.verify`): any error-severity finding raises one
    `VerifyError` listing every problem, before anything is compiled.
    `verify=False` raises at the first problem instead.

    `fault` (a `guard.chaos.FaultPlan`) arms deterministic fault
    injection: the outputs of the programs it matches are corrupted.
    Faulted compiles bypass the clean lowering cache and are never
    persisted to the tuning store."""
    raw = _to_raw(spec_or_builder)
    # the handle keeps its own copy: later caller-side mutation of the
    # spec dict must not make save()/spec/builder() disagree with the
    # already-compiled program
    raw = copy.deepcopy(raw)
    if spec_mod.is_loop_spec(raw):
        if fuse is not None or anchor is not None:
            raise ValueError(
                "fuse/anchor apply to dataflow programs; loop-program "
                "stages fuse according to the mode")
        impl = LoopProgram(raw, mode=mode, max_iters=max_iters,
                           device=device, tiles=tiles,
                           verify=verify, fault=fault)
        return Executable(impl=impl, raw=raw, kind="loop", mode=mode,
                          device=impl.device, tiles=tiles)
    if max_iters is not None:
        raise ValueError(
            "max_iters applies to loop programs; this spec has no "
            "iterate section")
    ir = lowering.compile_cached(raw, mode=mode, fuse=fuse, anchor=anchor,
                                 device=device, tiles=tiles,
                                 verify=verify, fault=fault)
    if tiles == "auto" and fault is None:
        # persist the compiled artifact once: the tuned flag (and a
        # tuned plan) belongs to the autotuner, so an existing record
        # is never overwritten by a plain compile
        store = tune_store.get_store()
        dk = lowering._device_kind(ir.device)
        if store.artifact_spec(ir.digest, ir.mode, ir.fuse, ir.anchor,
                               dk) is None:
            store.put_artifact(ir.digest, ir.mode, ir.fuse, ir.anchor,
                               dk, spec=ir.raw, plan=ir.tile_plan,
                               tuned=False)
    return Executable(impl=Program.from_ir(ir), raw=raw, kind="dataflow",
                      mode=mode, device=ir.device, fuse=ir.fuse,
                      anchor=ir.anchor, tiles=tiles)


def load(path, **compile_kwargs) -> Executable:
    """Compile a spec JSON file saved by `Executable.save` (or written
    by hand — it is the ordinary spec format)."""
    return compile(pathlib.Path(path), **compile_kwargs)
