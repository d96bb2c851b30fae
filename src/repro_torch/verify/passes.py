"""Analyzer lint passes over lowered loop programs and dataflow specs.

These run *after* the sink-threaded validation in `core.graph` /
`core.lowering` has recorded any structural errors, and look for the
class of problems that is legal to lower but wrong (or wasteful) to
run: dead bindings, never-updated feedback edges, constant `cond`
predicates, out-of-range stack indices, unguarded numerics, and groups
whose kernels ask for more shared memory per thread block than the card
allows (RV401).

RV401 is the one pass that differs from the reference's. The reference
prices a fused group's live windows (the spec's `window_size`) against
a 16 MiB VMEM budget. The port's kernels do not read `window_size`:
they choose their own blocks. So the port prices what each kernel of
the group requests per thread block under its plan, from the footprint
function of its kernel family (`footprint` in `kernels/window.py`,
`anchored.py`, `tiled.py`, `gemv.py`, `symv.py`, `gemm.py`, ...; the
autotuner filters its candidates with the same functions), against the
card's per-block opt-in maximum (`kernels.common.smem_budget`: 227 KiB
on sm_90, `REPRO_TORCH_SMEM_BUDGET` overrides it). A kernel over the
budget is an error; one over the share of an SM that its plan leaves
each resident block (half the budget, as the reference's warning, for
a kernel meant to keep two blocks on an SM) a warning. A spec the
reference flags for its window size alone (window_size 4096 on a gemm)
is clean here: ROADMAP Queue 3, item 5.

Loop passes walk the compiled stage tree (`CompiledStage`) so program
stage input bindings are already resolved (identity defaults applied);
dataflow passes walk the `ProgramSpec` + `DataflowGraph` pair.
"""
from __future__ import annotations

import math
from typing import Mapping

from repro_torch.core import fusion, routines as R
from repro_torch.core.spec import (CondStage, CountRule, InnerLoopStage,
                                   LoopSpec, ProgramSpec, dtype_name)

from .intervals import TOP, Interval, const_value, interval_of, is_nonneg

# ---------------------------------------------------------------------------
# Loop-program passes
# ---------------------------------------------------------------------------


def run_loop_passes(lspec: LoopSpec, lir, sink) -> None:
    """All loop-level lints. `lir` is the (possibly error-carrying)
    sink-mode LoopIR; None skips the passes that need resolved
    program-stage bindings."""
    _check_feedback_updates(lspec, sink)
    if lir is None:
        return
    _check_dead_bindings(lspec, lir, sink)
    _check_cond_predicates(lir, sink)
    _check_stack_bounds(lspec, lir, sink)
    _check_expr_safety(lspec, lir, sink)
    _check_duplicate_stores(lir.setup, "setup", sink)
    _check_duplicate_stores(lir.body, "iterate.body", sink)


# -- RV204: feedback edges that never change the state ----------------------


def _check_feedback_updates(lspec: LoopSpec, sink) -> None:
    def check(feedback: Mapping[str, str], prefix: str) -> None:
        for fname, src in feedback.items():
            if src == fname:
                sink.warn(
                    f"{prefix}.{fname}: state field {fname!r} feeds "
                    f"back its own value unchanged — the loop never "
                    f"updates it",
                    code="RV204", path=f"{prefix}.{fname}",
                    hint="feed back the updated value, or drop the "
                         "state field if it is loop-invariant")

    check(lspec.feedback, "iterate.feedback")
    for st, path in _spec_stages(lspec):
        if isinstance(st, InnerLoopStage):
            check(st.feedback, f"{path}.iterate.feedback")


def _spec_stages(lspec: LoopSpec):
    """Yield (stage, path) over setup + body, recursing into cond
    branches and nested loops."""
    def rec(stages, prefix):
        for i, st in enumerate(stages):
            where = f"{prefix}[{i}]"
            yield st, where
            if isinstance(st, CondStage):
                yield from rec(st.then, f"{where}.cond.then")
                yield from rec(st.orelse, f"{where}.cond.else")
            elif isinstance(st, InnerLoopStage):
                yield from rec(st.body, f"{where}.iterate.body")

    yield from rec(lspec.setup, "setup")
    yield from rec(lspec.body, "iterate.body")


# -- RV203: dead let/read bindings ------------------------------------------


def _collect_uses(cstages, used: set) -> None:
    for cs in cstages:
        st = cs.stage
        if cs.tag == "let":
            for _name, expr in st.bindings:
                used.update(expr.names)
        elif cs.tag == "program":
            used.update(cs.inputs.values())
        elif cs.tag == "read":
            used.add(st.source)
            used.update(st.slot.names)
        elif cs.tag == "store":
            used.add(st.value)
            used.update(st.slot.names)
            if st.at is not None:
                used.update(st.at.names)
        elif cs.tag == "cond":
            used.update(st.pred.names)
            _collect_uses(cs.then, used)
            _collect_uses(cs.orelse, used)
        elif cs.tag == "loop":
            for f in st.state:
                if f.init is not None:
                    used.update(f.init.names)
                for ref in (f.like, f.slot0, f.source):
                    if ref is not None:
                        used.add(ref)
            used.update(st.feedback.values())
            stop = st.stop
            if isinstance(stop, CountRule):
                used.update(stop.count.names)
            else:
                used.add(stop.metric)
                used.add(stop.init_metric)
                if isinstance(stop.scale, str):
                    used.add(stop.scale)
            _collect_uses(cs.body, used)


def _collect_bindings(cstages, prefix, out) -> None:
    for i, cs in enumerate(cstages):
        where = f"{prefix}[{i}]"
        st = cs.stage
        if cs.tag == "let":
            for name, _expr in st.bindings:
                out.append((name, f"{where}.{name}"))
        elif cs.tag == "read":
            out.append((st.name, f"{where}.read.name"))
        elif cs.tag == "cond":
            _collect_bindings(cs.then, f"{where}.cond.then", out)
            _collect_bindings(cs.orelse, f"{where}.cond.else", out)
        elif cs.tag == "loop":
            _collect_bindings(cs.body, f"{where}.iterate.body", out)


def _check_dead_bindings(lspec: LoopSpec, lir, sink) -> None:
    used: set = set()
    _collect_uses(lir.setup, used)
    _collect_uses(lir.body, used)
    used.update(lspec.feedback.values())
    stop = lspec.stop
    used.add(stop.metric)
    used.add(stop.init_metric)
    if isinstance(stop.scale, str):
        used.add(stop.scale)
    for f in lspec.state:
        if f.init is not None:
            used.update(f.init.names)
        for ref in (f.like, f.slot0, f.source):
            if ref is not None:
                used.add(ref)
    if lspec.guards is not None:
        # guard predicates read these every iteration — a value watched
        # only by a guard is still live
        used.update(lspec.guards.nonfinite)
        used.update(bg.value for bg in lspec.guards.breakdown)

    bindings: list = []
    _collect_bindings(lir.setup, "setup", bindings)
    _collect_bindings(lir.body, "iterate.body", bindings)
    for name, path in bindings:
        if name in used or name.startswith("_"):
            continue   # "_"-prefixed names opt out, scratch style
        sink.warn(
            f"{path}: {name!r} is bound but never used",
            code="RV203", path=path,
            hint="remove the binding, or prefix the name with '_' if "
                 "it is intentionally unused")


# -- RV205: statically-constant cond predicates -----------------------------


def _walk_compiled(cstages, prefix):
    for i, cs in enumerate(cstages):
        where = f"{prefix}[{i}]"
        yield cs, where
        if cs.tag == "cond":
            yield from _walk_compiled(cs.then, f"{where}.cond.then")
            yield from _walk_compiled(cs.orelse, f"{where}.cond.else")
        elif cs.tag == "loop":
            yield from _walk_compiled(cs.body, f"{where}.iterate.body")


def _check_cond_predicates(lir, sink) -> None:
    for scope, prefix in ((lir.setup, "setup"),
                          (lir.body, "iterate.body")):
        for cs, where in _walk_compiled(scope, prefix):
            if cs.tag != "cond":
                continue
            pred = cs.stage.pred
            if not pred.names:
                sink.warn(
                    f"{where}.cond.if: predicate {pred.src!r} has no "
                    f"runtime inputs — the same branch runs every "
                    f"iteration and the other is unreachable",
                    code="RV205", path=f"{where}.cond.if",
                    hint="compare against a loop value (e.g. the "
                         "driver-provided 'threshold'), or inline the "
                         "live branch")


# -- RV206: stack index bounds via counter range analysis -------------------


def _check_slot_bounds(target, slot_expr, env, stacks, path,
                       sink) -> None:
    slots = stacks.get(target)
    if slots is None:
        return
    iv = interval_of(slot_expr.ast, env)
    if iv.lo > slots - 1 or iv.hi < 0:
        sink.error(
            f"{path}: slot index {slot_expr.src!r} is provably out of "
            f"range for stack {target!r} — index in "
            f"[{iv.lo:g}, {iv.hi:g}], stack has {slots} slots",
            code="RV206", path=path,
            hint=f"valid slots are 0..{slots - 1}")
    elif iv.hi > slots - 1 and not math.isinf(iv.hi):
        sink.warn(
            f"{path}: slot index {slot_expr.src!r} can reach "
            f"{iv.hi:g}, past the last slot of {target!r} "
            f"({slots} slots)",
            code="RV206", path=path,
            hint=f"valid slots are 0..{slots - 1}")
    elif iv.lo < 0 and not math.isinf(iv.lo):
        sink.warn(
            f"{path}: slot index {slot_expr.src!r} can reach "
            f"{iv.lo:g}, below slot 0 of {target!r}",
            code="RV206", path=path,
            hint=f"valid slots are 0..{slots - 1}")


def _bounds_walk(cstages, env, stacks, prefix, sink) -> None:
    for i, cs in enumerate(cstages):
        where = f"{prefix}[{i}]"
        st = cs.stage
        if cs.tag == "let":
            for name, expr in st.bindings:
                env[name] = interval_of(expr.ast, env)
        elif cs.tag == "read":
            _check_slot_bounds(st.source, st.slot, env, stacks,
                               f"{where}.read.slot", sink)
            env[st.name] = TOP
        elif cs.tag == "store":
            _check_slot_bounds(st.into, st.slot, env, stacks,
                               f"{where}.store.slot", sink)
        elif cs.tag == "program":
            for env_name in cs.outputs.values():
                env[env_name] = TOP
        elif cs.tag == "cond":
            _bounds_walk(cs.then, dict(env), stacks,
                         f"{where}.cond.then", sink)
            _bounds_walk(cs.orelse, dict(env), stacks,
                         f"{where}.cond.else", sink)
            for name in cs.produced:
                env[name] = TOP
        elif cs.tag == "loop":
            ienv = dict(env)
            istacks = dict(stacks)
            for f in st.state:
                if f.is_stack:
                    istacks[f.name] = f.slots
                ienv[f.name] = TOP
            if st.counter is not None:
                count = None
                if isinstance(st.stop, CountRule):
                    count = const_value(st.stop.count.ast)
                if count is not None and count >= 1:
                    ienv[st.counter] = Interval(0.0, count - 1)
                else:
                    ienv[st.counter] = Interval(0.0, math.inf)
            _bounds_walk(cs.body, ienv, istacks,
                         f"{where}.iterate.body", sink)
            for outer_name in st.yields:
                env[outer_name] = TOP


def _check_stack_bounds(lspec: LoopSpec, lir, sink) -> None:
    env: dict = {}
    _bounds_walk(lir.setup, env, {}, "setup", sink)
    stacks = {f.name: f.slots for f in lspec.state if f.is_stack}
    for f in lspec.state:
        env[f.name] = TOP
    _bounds_walk(lir.body, dict(env), stacks, "iterate.body", sink)


# -- RV301 / RV302 / RV303: expression numerics -----------------------------


def _expr_safety(expr, path, nonneg, sink) -> None:
    def rec(node):
        tag = node[0]
        if tag in ("+", "-", "*", "/"):
            rec(node[1])
            rec(node[2])
            if tag == "/":
                cv = const_value(node[2])
                if cv == 0.0:
                    sink.error(
                        f"{path}: division by constant zero in "
                        f"{expr.src!r}",
                        code="RV301", path=path,
                        hint="the denominator folds to 0; the result "
                             "would be the safe-divide fill value "
                             "every iteration")
                elif cv is None:
                    sink.info(
                        f"{path}: division in {expr.src!r} has a "
                        f"runtime denominator; it lowers to the "
                        f"library safe divide (0 on a zero "
                        f"denominator)",
                        code="RV303", path=path)
        elif tag == "neg":
            rec(node[1])
        elif tag == "call":
            rec(node[2])
            if node[1] == "sqrt":
                cv = const_value(node[2])
                if cv is not None and cv < 0:
                    sink.error(
                        f"{path}: sqrt of negative constant "
                        f"{cv:g} in {expr.src!r} is NaN",
                        code="RV302", path=path)
                elif cv is None and not is_nonneg(node[2], nonneg):
                    sink.warn(
                        f"{path}: sqrt argument in {expr.src!r} is "
                        f"not provably nonnegative (NaN at runtime "
                        f"if it dips below zero)",
                        code="RV302", path=path,
                        hint="square/abs the argument, or guard it "
                             "with a cond")
        elif tag == "cmp":
            rec(node[2])
            rec(node[3])
    rec(expr.ast)


# routines whose outputs are nonnegative by construction (|.| sums,
# maxima, norms) — their published names seed the sqrt-safety proof
_NONNEG_ROUTINES = frozenset({"nrm2", "asum", "amax"})


def _nonneg_program_outputs(cs) -> frozenset:
    """Outer env names a program stage provably publishes as
    nonnegative: outputs of absolute-value reductions, plus coldot
    Gram diagonals whose two panel ports bind the same value (a sum
    of squares, e.g. block-CG's diag(RᵀR))."""
    ir = cs.ir
    if ir is None or ir.graph is None:
        return frozenset()
    graph = ir.graph
    out = set()
    for po in graph.outputs:
        rspec = graph.nodes.get(po.routine)
        if rspec is None:
            continue
        ok = rspec.blas in _NONNEG_ROUTINES
        if not ok and rspec.blas == "coldot":
            srcs = []
            for port in ("x", "y"):
                e = graph.producer_of(po.routine, port)
                if e is not None:
                    srcs.append(("edge", e.src, e.src_port))
                else:
                    pub = rspec.input_aliases.get(
                        port, f"{po.routine}.{port}")
                    srcs.append(("input", cs.inputs.get(pub, pub)))
            ok = srcs[0] == srcs[1]
        if ok:
            out.add(cs.outputs.get(po.name, po.name))
    return frozenset(out)


def _safety_walk(cstages, nonneg: frozenset, prefix, sink) -> frozenset:
    for i, cs in enumerate(cstages):
        where = f"{prefix}[{i}]"
        st = cs.stage
        if cs.tag == "program":
            nonneg = nonneg | _nonneg_program_outputs(cs)
        elif cs.tag == "let":
            for name, expr in st.bindings:
                _expr_safety(expr, f"{where}.{name}", nonneg, sink)
                if is_nonneg(expr.ast, nonneg):
                    nonneg = nonneg | {name}
        elif cs.tag == "read":
            _expr_safety(st.slot, f"{where}.read.slot", nonneg, sink)
        elif cs.tag == "store":
            _expr_safety(st.slot, f"{where}.store.slot", nonneg, sink)
            if st.at is not None:
                _expr_safety(st.at, f"{where}.store.at", nonneg, sink)
        elif cs.tag == "cond":
            _expr_safety(st.pred, f"{where}.cond.if", nonneg, sink)
            _safety_walk(cs.then, nonneg, f"{where}.cond.then", sink)
            _safety_walk(cs.orelse, nonneg, f"{where}.cond.else", sink)
        elif cs.tag == "loop":
            inner = nonneg
            if st.counter is not None:
                inner = inner | {st.counter}
            for f in st.state:
                if f.init is not None:
                    _expr_safety(f.init,
                                 f"{where}.iterate.state.{f.name}",
                                 nonneg, sink)
            if isinstance(st.stop, CountRule):
                _expr_safety(st.stop.count,
                             f"{where}.iterate.while.count", nonneg,
                             sink)
            _safety_walk(cs.body, inner, f"{where}.iterate.body", sink)
    return nonneg


def _check_expr_safety(lspec: LoopSpec, lir, sink) -> None:
    nonneg = _safety_walk(lir.setup, frozenset(), "setup", sink)
    for f in lspec.state:
        if f.init is not None:
            _expr_safety(f.init, f"iterate.state.{f.name}", nonneg,
                         sink)
    _safety_walk(lir.body, nonneg, "iterate.body", sink)


# -- RV403: duplicate whole-slot stores -------------------------------------


def _check_duplicate_stores(cstages, prefix, sink) -> None:
    seen: dict = {}
    for i, cs in enumerate(cstages):
        where = f"{prefix}[{i}]"
        if cs.tag == "loop":
            _check_duplicate_stores(cs.body, f"{where}.iterate.body",
                                    sink)
            continue
        if cs.tag != "store":
            continue
        st = cs.stage
        if st.at is not None:
            continue   # element stores into one slot compose
        key = (st.into, st.slot.src)
        first = seen.get(key)
        if first is not None:
            sink.warn(
                f"{where}.store: stack {st.into!r} slot "
                f"{st.slot.src!r} is stored twice in one iteration "
                f"(first at {first}); the second store wins",
                code="RV403", path=f"{where}.store",
                hint="drop the earlier store, or store to a "
                     "different slot")
        else:
            seen[key] = f"{where}.store"


# ---------------------------------------------------------------------------
# Dataflow-program passes
# ---------------------------------------------------------------------------


def run_dataflow_passes(spec: ProgramSpec, graph, sink, *,
                        mode: str = "dataflow") -> None:
    _check_accumulation_dtype(spec, sink)
    _check_window_alignment(spec, sink)
    _check_smem_budget(spec, graph, sink, mode=mode)


def _check_accumulation_dtype(spec: ProgramSpec, sink) -> None:
    dname = dtype_name(spec.dtype)
    if dname == "float32":
        return
    for ri, r in enumerate(spec.routines):
        if r.rdef.reduction or r.rdef.index_reduction:
            sink.warn(
                f"routines[{ri}]: reduction routine {r.blas!r} runs "
                f"at {dname}; accumulating long sums below float32 "
                f"loses significance",
                code="RV110", path=f"routines[{ri}]",
                hint="use dtype float32, or accept the rounding of "
                     "the reduced result")


def _check_window_alignment(spec: ProgramSpec, sink) -> None:
    for ri, r in enumerate(spec.routines):
        if r.vector_width and r.window_size % r.vector_width != 0:
            sink.warn(
                f"routines[{ri}].window_size: {r.window_size} is not "
                f"a multiple of vector_width {r.vector_width}; the "
                f"trailing partial window pads and wastes lanes",
                code="RV402", path=f"routines[{ri}].window_size",
                hint=f"round window_size to a multiple of "
                     f"{r.vector_width}")


def group_footprint(graph, g, itemsize: int, cfg=None):
    """The footprints (`kernels.common.Footprint`) of the kernels one
    fusion group launches under the tile config `cfg` (None: the default
    plans), for any operand shape: a fused group's generated kernel (and
    its anchor's product), else each member's standalone kernel. A
    routine that runs its plain version in every mode prices nothing."""
    from repro_torch.core import codegen
    from repro_torch.kernels import (anchored, gemm, gemv, ger, symv,
                                     tiled, transpose, window)

    if g.fused and len(g.nodes) >= 2:
        if g.anchor is None:
            sig = codegen._group_signature(graph, g)
            return window.footprint(codegen.group_body(graph, g, sig))
        if R.OUT_MAT in set(graph.nodes[g.anchor].rdef.outputs.values()):
            sig = codegen._tiled_signature(graph, g)
            return tiled.footprint(codegen.tiled_body(graph, g, sig),
                                   itemsize, cfg)
        sig = codegen._anchored_signature(graph, g)
        return anchored.footprint(codegen.anchored_body(graph, g, sig),
                                  itemsize, cfg)
    out = ()
    for name in g.nodes:
        rspec = graph.nodes[name]
        if rspec.rdef.kernel is None:
            continue
        blas = rspec.blas
        if blas == "gemv":
            out += gemv.gemv_footprint(itemsize, cfg)
        elif blas == "gemvt":
            out += gemv.gemvt_footprint(itemsize, cfg)
        elif blas == "symv":
            out += symv.footprint(itemsize, cfg)
        elif blas == "gemm":
            out += gemm.footprint(itemsize, cfg)
        elif blas == "ger":
            out += ger.footprint(itemsize)
        elif blas == "transpose":
            out += transpose.footprint(itemsize)
        elif rspec.rdef.level == 1:
            rdef = rspec.rdef
            out += window.footprint(window.WindowBody(
                n_scalars=0, n_inputs=0,
                sums=(("", None),) if rdef.reduction else (),
                argmaxes=("",) if rdef.index_reduction else ()))
    return out


def worst_footprint(prints, budget: int):
    """The footprint of `prints` that fares worst against `budget`:
    (severity or None, footprint). Error: over the budget; warning: over
    the share of the budget one of its plan's resident blocks has."""
    worst = (0, 0, None)
    for fp in prints:
        level = 2 if fp.bytes > budget else \
            1 if fp.bytes > budget // max(fp.blocks, 1) else 0
        rank = (level, fp.bytes)
        if worst[2] is None or rank > worst[:2]:
            worst = (level, fp.bytes, fp)
    return {2: "error", 1: "warning", 0: None}[worst[0]], worst[2]


def _check_smem_budget(spec: ProgramSpec, graph, sink, *,
                       mode: str) -> None:
    if graph.order is None or mode == "reference":
        # a cycle (already recorded), or the plain versions: no kernel
        return
    try:
        groups = fusion.plan(graph, enable=(mode == "dataflow"))
    except Exception:
        return   # planning needs a well-formed graph; errors recorded
    from repro_torch.kernels import common

    itemsize = spec.dtype.itemsize
    budget = common.smem_budget()
    index = {r.name: ri for ri, r in enumerate(spec.routines)}
    for g in graph_groups_sorted(groups):
        severity, fp = worst_footprint(
            group_footprint(graph, g, itemsize), budget)
        if severity is None:
            continue
        ri = min(index.get(n, 0) for n in g.nodes)
        label = "+".join(graph.nodes[n].blas for n in g.nodes)
        msg = (f"routines[{ri}]: group [{label}] asks ~{fp.bytes >> 10} "
               f"KiB of shared memory per thread block ({fp.kernel}) "
               f"against a {budget >> 10} KiB per-block budget")
        hint = ("split the group (fuse=False or a smaller anchor), tune "
                "it to smaller blocks, or raise REPRO_TORCH_SMEM_BUDGET "
                "if the card allows it")
        if severity == "error":
            sink.error(msg, code="RV401", path=f"routines[{ri}]",
                       hint=hint)
        else:
            sink.warn(msg + f" (over the share of {fp.blocks} resident "
                      f"blocks)", code="RV401", path=f"routines[{ri}]",
                      hint=hint)


def graph_groups_sorted(groups):
    return sorted(groups, key=lambda g: sorted(g.nodes))
