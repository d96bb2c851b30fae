"""Drivers that run dataflow-composed iteration bodies on the card.

Two ways to describe an iteration, one driver underneath:

* `SolverProgram` — subclass hooks written in Python (`_init_state` /
  `_step` / `_solution`) built from compiled `core.runtime.Program`
  bodies (`_program`). The class-based solvers of `iterative.py` (CG,
  BiCGStab, Jacobi, PowerIteration) use it.
* `LoopProgram` — the iteration itself is described in the JSON spec
  (`iterate` section: state fields, feedback edges for vectors,
  matrices and scalars, scalar update expressions, stacks with their
  `read`/`store` stages, nested `iterate` loops, stop rule, guards)
  and executed generically. CG, Jacobi, BiCGStab, block-CG and
  GMRES(m) run this way.

The reference runs the whole solve as one on-device `lax.while_loop`
under one `jax.jit`. PyTorch runs eagerly, so the port runs a host
loop over the compiled stage programs instead. Everything the loop
carries stays on the device: the state, the residual, the stop
threshold `tol * max(scale, 1e-30)` (float32), the residual history
(float32, NaN past the stop) and the status (one int8). Each iteration
computes its status on the device, in the reference's layering, and
the host reads that one byte to decide whether to go on: the only
synchronisation of an iteration without a `cond` stage. A `cond` stage
reads its predicate and runs one branch, as `lax.cond` does. Every
stage program launches its kernels without waiting for the device.
Capturing the body in a CUDA graph, which would also remove the host's
per-launch time, is ROADMAP Queue 1, item 18.

Nested loops are host loops too. Their counters are host ints, and a
slot, `at` or count expression over counters and literals only (GMRES's
`j + 1`, `19 - i`, `count: 20`) is folded to a host int: such a loop
and its reads and stores wait for nothing. Any other slot is a 0-d
int64 on the device (`index_select` / `index_put_`), and any other count
is read once when the loop starts. A nested loop with a metric stop
rule reads its metric once per inner iteration, as the outer loop reads
its status byte. Indices follow the reference: a negative one counts
from the end, a read clamps into range and a store out of range is
dropped.

Stacks are written in place, and the driver keeps `jax.numpy`'s value
semantics around that: each entry into a loop allocates fresh stacks
(so a yielded buffer is never written again), a stack made with
`init.from` adopts a copy of its source, and a read of a stack that a
running loop may still store into, like a bare-name alias of one, binds
a copy (`CompiledStage.copy`). A store casts to the stack's dtype; a
0-d device value is copied on the device, with no host wait.

`trace_count` counts how many times the solve is assembled from the
compiled stage programs: once per driver, however many solves it runs
(the reference counts traces of its loop body, and holds them to one).

The `repro_torch.obs` records are the reference's: a `loop.trace` event
per build, a `solver.solve` span per solve (waiting for the device at
its end), a `loop.inner` span per nested loop and a `solver.result`
event (iterations, final residual, converged, status), which reads
those values from the device only while recording. The guarded step of
a `LoopProgram` publishes the outer loop's counter to
`guard.chaos.loop_iteration`, so a fault plan that targets an
iteration fires there, in the stages of nested loops too, and never in
the setup stages.

A batched solve (`LoopProgram.batched`, `solve_batched`) runs the same
compiled solve once per lane, where the reference vmaps it: each lane
stops at its own iteration, as a vmapped lane does, and every result
field is stacked along a new axis 0. The whole call is one
`solver.solve` span (`batched=True`) with one `solver.result` event of
per-lane lists.
"""
from __future__ import annotations

import dataclasses
from numbers import Number
from typing import Dict, Mapping, Optional

import torch

from repro_torch import obs
from repro_torch.core import lowering
from repro_torch.core.expr import sdiv as _sdiv  # noqa: F401  (re-export)
from repro_torch.core.runtime import Program
from repro_torch.core.spec import CountRule, SpecError
from repro_torch.guard import chaos, status as ST
from repro_torch.kernels.common import resolve_device

_TINY = 1e-30


@dataclasses.dataclass
class SolverResult:
    """Outcome of one solve; every field a tensor on the solve's
    device (with a leading right-hand-side axis from a batched
    solve)."""
    x: torch.Tensor            # solution (eigvec for eigen-solvers)
    iterations: torch.Tensor   # int32 — iterations actually run
    residual: torch.Tensor     # final convergence metric
    history: torch.Tensor      # (max_iters + 1,) f32; NaN past the stop
    converged: torch.Tensor    # bool
    # int8 guard.status code (CONVERGED/MAX_ITERS/BREAKDOWN/NONFINITE/
    # DIVERGED/STAGNATED), per lane for batched solves
    status: Optional[torch.Tensor] = None
    aux: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the escalation ladder's attempt log (guard.escalate.Attempt
    # records); None for plain solves
    attempts: Optional[list] = None

    def __repr__(self):
        if self.iterations.ndim:    # batched result
            return (f"SolverResult(batch={self.iterations.shape[0]}, "
                    f"iterations={self.iterations.tolist()}, "
                    f"status={self.status_names()})")
        return (f"SolverResult(iterations={int(self.iterations)}, "
                f"residual={float(self.residual):.3e}, "
                f"status={self.status_names()})")

    def status_names(self):
        """The status code as its name, or a per-lane list of names
        for batched results."""
        if self.status.ndim:
            return [ST.status_name(s) for s in self.status]
        return ST.status_name(self.status)

    def history_trimmed(self):
        """Residual history without the NaN tail past the stopping
        point: a (iterations + 1,) numpy array, or a per-lane list of
        such arrays for batched results (lanes stop at different
        iterations, so the trimmed histories are ragged)."""
        hist = self.history.detach().cpu().numpy()
        its = self.iterations.detach().cpu().numpy()
        if its.ndim:
            return [hist[lane, :int(k) + 1] for lane, k in enumerate(its)]
        return hist[:int(its) + 1]


def lanes(operands: Mapping, in_axes: Mapping) -> int:
    """The common size of the batched operands' lane axes."""
    sizes = {name: operands[name].shape[axis]
             for name, axis in in_axes.items()
             if axis is not None and name in operands}
    if not sizes:
        raise ValueError("batched() needs at least one input with a batch "
                         "axis (every axis is None)")
    if len(set(sizes.values())) != 1:
        raise ValueError(f"batched(): inputs disagree on the batch size: "
                         f"{sizes}")
    return next(iter(sizes.values()))


def lane_of(operands: Mapping, in_axes: Mapping, lane: int) -> dict:
    """One lane's operands: each batched one selected on its axis (a
    contiguous copy where that is a strided view, as the kernels take
    contiguous vectors), the rest passed whole."""
    return {n: (v if in_axes.get(n) is None
                else v.select(in_axes[n], lane).contiguous())
            for n, v in operands.items()}


def _stack(results) -> SolverResult:
    """Per-lane results stacked field by field along a new axis 0."""
    first = results[0]
    return SolverResult(
        **{f: torch.stack([getattr(r, f) for r in results])
           for f in ("x", "iterations", "residual", "history",
                     "converged", "status")},
        aux={k: torch.stack([r.aux[k] for r in results])
             for k in first.aux})


def _code(code: int, device) -> torch.Tensor:
    """A 0-d int8 status code on `device`, filled there."""
    return torch.full((), code, dtype=torch.int8, device=device)


def _f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on `device`; a host number is filled there
    (a copy from pageable host memory would make the host wait)."""
    if isinstance(value, Number):
        return torch.full((), float(value), dtype=torch.float32,
                          device=device)
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(())


def _evaluate(expr, env):
    """An expression's value: a host number when every name it uses is
    one (loop counters, literals and what is folded from them: float32
    arithmetic on the host, no device wait), else a tensor."""
    v = expr.evaluate(env)
    if torch.is_tensor(v) and all(isinstance(env[n], Number)
                                  for n in expr.names):
        return v.item()
    return v


def _index(expr, env, size):
    """A slot or `at` index, truncated as the reference's int32 cast and
    negative ones counted from the end: a host int where the expression
    folds on the host, else a 0-d int64 on the device."""
    v = _evaluate(expr, env)
    if isinstance(v, Number):
        i = int(v)
        return i + size if i < 0 else i
    i = v.to(torch.int64)
    return torch.where(i < 0, i + size, i)


def _read(buf, i, copy):
    """buf[i] along the leading axis, the index clamped into range (as
    `lax.dynamic_index_in_dim`); a copy when `copy` (a live stack)."""
    last = buf.shape[0] - 1
    if isinstance(i, int):
        v = buf[min(max(i, 0), last)]
        return v.clone() if copy else v
    return buf.index_select(0, i.clamp(0, last).reshape(1)).squeeze(0)


def _store(buf, index, value):
    """buf[index] = value in place, cast to buf's dtype; an index out of
    range drops the store, as the reference's scatter does."""
    if all(isinstance(i, int) for i in index):
        if all(0 <= i < n for i, n in zip(index, buf.shape)):
            buf[index] = value
        return
    dev = buf.device
    idx = [i.reshape(1) if torch.is_tensor(i) else
           torch.full((1,), i, dtype=torch.int64, device=dev)
           for i in index]
    ok = torch.ones(1, dtype=torch.bool, device=dev)
    for k, (i, n) in enumerate(zip(idx, buf.shape)):
        ok = ok & (i >= 0) & (i < n)
        idx[k] = i.clamp(0, n - 1)
    old = buf[tuple(idx)]
    if torch.is_tensor(value):
        value = value.to(buf.dtype)
    ok = ok.reshape((1,) * old.ndim)
    buf.index_put_(tuple(idx), torch.where(ok, value, old))


class SolverProgram:
    """Base driver for iterative solvers over AIEBLAS dataflow programs.
    It runs on the CUDA card unless built with `device="cpu"`."""

    name = "solver"

    def __init__(self, *, mode: str = "dataflow", max_iters: int = 200,
                 device=None):
        if mode not in ("dataflow", "nodataflow", "reference"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.max_iters = int(max_iters)
        self.device = resolve_device(device)
        self.trace_count = 0
        self._solve_fn = None

    # -- subclass hooks -------------------------------------------------

    def _init_state(self, operands):
        raise NotImplementedError

    def _step(self, operands, state, threshold):
        raise NotImplementedError

    def _solution(self, state):
        raise NotImplementedError

    def _guards(self):
        """The GuardSpec of the guarded loop, or None for the ungated
        loop (no guards section)."""
        return None

    def _step_guarded(self, operands, state, threshold, k):
        """Guarded-path step hook: like `_step` but also returns an
        int8 in-body fault code on the device (RUNNING when clean)."""
        st, res = self._step(operands, state, threshold)
        return st, res, None

    # -- plumbing -------------------------------------------------------

    def _program(self, spec) -> Program:
        """Compile one iteration-body piece through the full lowering
        pipeline on the solver's device; repeated bodies hit the
        digest-keyed program cache and compile once."""
        return Program.from_spec(spec, mode=self.mode, device=self.device)

    def _start(self, operands, tol):
        """Setup: (state, first metric, stop threshold, history)."""
        dev = self.device
        state, res0, scale = self._init_state(operands)
        res0 = _f32(res0, dev)
        threshold = _f32(tol, dev) * torch.clamp_min(_f32(scale, dev),
                                                     _TINY)
        hist = torch.full((self.max_iters + 1,), float("nan"),
                          dtype=torch.float32, device=dev)
        hist[0] = res0
        return state, res0, threshold, hist

    def _build(self):
        """Assemble the solve from the compiled stage programs (the
        counterpart of the reference's trace of its loop body)."""
        self.trace_count += 1
        obs.event("loop.trace", program=self.name, mode=self.mode,
                  trace=self.trace_count)
        guards = self._guards()
        return self._solve_plain if guards is None else \
            lambda operands, tol: self._solve_guarded(operands, tol, guards)

    def _solve_plain(self, operands, tol):
        """The ungated loop: iterate while k < max_iters and
        res > threshold."""
        state, res, threshold, hist = self._start(operands, tol)
        k = 0
        while k < self.max_iters and bool(res > threshold):
            state, res = self._step(operands, state, threshold)
            res = _f32(res, self.device)
            hist[k + 1] = res
            k += 1
        return dict(state=state, iterations=k, residual=res, history=hist,
                    converged=res <= threshold, status=None)

    def _solve_guarded(self, operands, tol, guards):
        """The guarded loop: the status is an int8 on the device, and
        the loop runs while it reads RUNNING. Each iteration classifies
        the new metric as the reference does (later writes win):
        MAX_ITERS and STAGNATED, then DIVERGED, CONVERGED, NONFINITE and
        last the in-body fault, whose BREAKDOWN already outranks
        NONFINITE."""
        dev = self.device
        window = guards.stagnation
        keep = _f32(1.0 - guards.min_drop, dev)
        state, res0, threshold, hist = self._start(operands, tol)
        div_limit = None
        if guards.divergence is not None:
            div_limit = _f32(guards.divergence, dev) * torch.clamp_min(
                res0, _TINY)
        # codes enter as kernel arguments (torch.full, torch.where on a
        # Python int): a tensor built from a host value would copy it
        # from pageable memory and make the host wait for the device
        status = _code(ST.RUNNING, dev)
        status = torch.where(res0 <= threshold, ST.CONVERGED, status)
        status = torch.where(torch.isfinite(res0), status, ST.NONFINITE)
        if self.max_iters <= 0:     # degenerate budget: never iterate
            status = torch.where(status == ST.RUNNING, ST.MAX_ITERS,
                                 status)
        res, best = res0, res0
        stall = torch.zeros((), dtype=torch.int32, device=dev)
        k = 0
        while int(status) == ST.RUNNING:   # the iteration's one sync
            state, res, fault = self._step_guarded(operands, state,
                                                   threshold, k)
            res = _f32(res, dev)
            hist[k + 1] = res
            k += 1
            stall = torch.where(res < best * keep, 0, stall + 1)
            best = torch.minimum(best, res)
            status = _code(ST.MAX_ITERS if k >= self.max_iters
                           else ST.RUNNING, dev)
            if window is not None:
                status = torch.where(stall >= window, ST.STAGNATED, status)
            if div_limit is not None:
                status = torch.where(res > div_limit, ST.DIVERGED, status)
            status = torch.where(res <= threshold, ST.CONVERGED, status)
            status = torch.where(torch.isfinite(res), status, ST.NONFINITE)
            if fault is not None:
                status = torch.where(fault != ST.RUNNING, fault, status)
        return dict(state=state, iterations=k, residual=res, history=hist,
                    converged=status == ST.CONVERGED, status=status)

    def _package(self, out) -> SolverResult:
        sol = dict(self._solution(out["state"]))
        status = out["status"]
        if status is None:
            # ungated loop: converged or budget exhausted
            status = torch.where(out["converged"], ST.CONVERGED,
                                 _code(ST.MAX_ITERS, self.device))
        return SolverResult(
            x=sol.pop("x"),
            iterations=torch.tensor(out["iterations"], dtype=torch.int32,
                                    device=self.device),
            residual=out["residual"], history=out["history"],
            converged=out["converged"], status=status, aux=sol)

    def _export_result(self, res: SolverResult, *,
                       batched: bool = False) -> None:
        """Convergence telemetry: one `solver.result` event per solve
        (iterations, final residual, converged, status), per lane for
        batched solves, read from the device only while recording."""
        if not obs.enabled():
            return

        def values(t, cast):
            return [cast(v) for v in t] if batched else cast(t)

        lanes_ = {"batch": int(res.iterations.shape[0])} if batched else {}
        obs.event("solver.result", program=self.name, mode=self.mode,
                  **lanes_, iterations=values(res.iterations, int),
                  final_residual=values(res.residual, float),
                  converged=values(res.converged, bool),
                  status=res.status_names())

    def _run(self, operands: Dict[str, torch.Tensor],
             tol: float) -> SolverResult:
        if self._solve_fn is None:
            self._solve_fn = self._build()
        with obs.span("solver.solve", program=self.name, mode=self.mode):
            out = self._solve_fn(operands, tol)
            if obs.enabled() and obs.concrete():
                obs.block((out["history"],))
        res = self._package(out)
        self._export_result(res)
        return res

    def _run_batched(self, operands: Dict[str, torch.Tensor], tol: float,
                     in_axes: Mapping[str, Optional[int]]) -> SolverResult:
        """One run of the compiled solve per lane, on that lane's
        operands (`lane_of`), and the results stacked along a new axis
        0: lanes stop on their own, as the reference's vmapped lanes
        do, and each lane records no span or event of its own."""
        if self._solve_fn is None:
            self._solve_fn = self._build()
        with obs.span("solver.solve", program=self.name, mode=self.mode,
                      batched=True):
            res = _stack([
                self._package(self._solve_fn(
                    lane_of(operands, in_axes, lane), tol))
                for lane in range(lanes(operands, in_axes))])
            if obs.enabled() and obs.concrete():
                obs.block((res.history,))
        self._export_result(res, batched=True)
        return res

    def describe(self) -> str:
        """Fusion-plan report for every compiled iteration-body piece."""
        lines = [f"solver {self.name!r} mode={self.mode} "
                 f"max_iters={self.max_iters}"]
        for attr in sorted(vars(self)):
            prog = getattr(self, attr)
            if isinstance(prog, Program):
                lines.append(prog.describe())
        return "\n".join(lines)


class LoopProgram(SolverProgram):
    """Generic executor for JSON-described loop programs.

    The spec's `iterate` section IS the solver: state init, the staged
    dataflow body, scalar update expressions, feedback edges, the stop
    rule and the guards all come from JSON (`core.spec.parse_loop` +
    `core.lowering.lower_loop`); this class only threads values between
    compiled stage programs inside the shared host loop. Stage programs
    are compiled through the digest-keyed program cache, so bodies
    shared between loop specs compile once per mode and device.
    """

    def __init__(self, spec, *, mode: Optional[str] = None,
                 max_iters: Optional[int] = None, device=None,
                 tiles="auto", verify: bool = True, fault=None):
        if isinstance(spec, lowering.LoopIR):
            # a pre-lowered IR fixes mode and device: its stage kernels
            # are already compiled for that configuration
            lir = spec
            if mode is not None and mode != lir.mode:
                raise ValueError(
                    f"LoopIR was lowered for mode={lir.mode!r}; "
                    f"cannot run it as mode={mode!r}")
            if device is not None and resolve_device(device) != lir.device:
                raise ValueError(
                    f"LoopIR was lowered for device={str(lir.device)!r}; "
                    f"cannot run it on {device!r}")
            if fault is not None:
                raise ValueError(
                    "fault plans must be threaded through lowering; "
                    "pass the raw spec (not a pre-lowered LoopIR) "
                    "together with fault=")
            mode = lir.mode
        else:
            mode = "dataflow" if mode is None else mode
            lir = lowering.lower_loop(spec, mode=mode, device=device,
                                      tiles=tiles, verify=verify,
                                      fault=fault)
        self.lir = lir
        self.name = lir.lspec.name
        if "x" not in lir.lspec.solution:
            raise SpecError(
                f"loop {self.name!r}: iterate.solution must bind 'x' "
                f"(the primary solution the driver reports)")
        super().__init__(
            mode=mode,
            max_iters=(lir.lspec.stop.max_iters
                       if max_iters is None else max_iters),
            device=lir.device)
        self._setup_env = None

    # -- spec-driven driver hooks ---------------------------------------

    def _run_stages(self, stages, env):
        for cs in stages:
            st = cs.stage
            if cs.tag == "let":
                for name, expr in st.bindings:
                    v = _evaluate(expr, env)
                    env[name] = v.clone() if name in cs.copy else v
            elif cs.tag == "program":
                out = cs.ir.fn({pub: env[src]
                                for pub, src in cs.inputs.items()})
                for pub, dst in cs.outputs.items():
                    env[dst] = out[pub]
            elif cs.tag == "read":
                buf = env[st.source]
                env[st.name] = _read(buf, _index(st.slot, env,
                                                 buf.shape[0]),
                                     copy=bool(cs.copy))
            elif cs.tag == "store":
                buf = env[st.into]
                index = (_index(st.slot, env, buf.shape[0]),)
                if st.at is not None:
                    index += (_index(st.at, env, buf.shape[1]),)
                _store(buf, index, env[st.value])
            elif cs.tag == "cond":
                # the predicate is read on the host and one branch runs;
                # only the names both branches produce survive it
                taken = cs.then if bool(_evaluate(st.pred, env)) \
                    else cs.orelse
                benv = self._run_stages(taken, dict(env))
                env.update((n, benv[n]) for n in cs.produced)
            else:                     # "loop": nested iterate
                self._run_inner(cs, env)
        return env

    def _run_inner(self, cs, env):
        """One nested iterate, run to its end: inner state initialised
        from the enclosing environment (fresh stacks), its stages run
        per inner iteration with the counter bound to a host int, and
        its yields bound into `env`. A count loop waits for nothing
        when its count folds on the host; a metric rule reads its
        metric once per inner iteration. While recording (outside a
        capture) the whole inner loop is one `loop.inner` span of host
        time: it issues the loop's launches and waits only where the
        loop itself does."""
        timed = obs.enabled() and obs.concrete()
        with (obs.span("loop.inner", program=self.name,
                       counter=cs.stage.counter) if timed
              else obs.NULL_SPAN):
            self._run_inner_body(cs, env)

    def _run_inner_body(self, cs, env):
        ispec = cs.stage
        state = self._init_fields(ispec.state, env, cs.copy)
        stop = ispec.stop

        def step(k, st):
            benv = dict(env)
            benv.update(st)
            if ispec.counter is not None:
                benv[ispec.counter] = k
            benv = self._run_stages(cs.body, benv)
            return benv, self._next_state(ispec, st, benv,
                                          cs.feedback_copy)

        if isinstance(stop, CountRule):
            # truncated, as the reference's int32 cast of the count
            for k in range(int(_evaluate(stop.count, env))):
                _, state = step(k, state)
        else:
            dev = self.device
            scale = (env[stop.scale] if isinstance(stop.scale, str)
                     else stop.scale)
            thr = torch.clamp_min(_f32(scale, dev), _TINY) * stop.rtol
            res = _f32(env[stop.init_metric], dev)
            k = 0
            while k < stop.max_iters and bool(res > thr):
                benv, state = step(k, state)
                res = _f32(benv[stop.metric], dev)
                k += 1
        for outer_name, field in ispec.yields.items():
            env[outer_name] = state[field]

    def _make_stack(self, f, env):
        """Allocate one stack buffer: zeros (optionally slot 0 seeded),
        or a contiguous copy of a whole buffer from the environment."""
        dtype = self.lir.lspec.dtype
        if f.source is not None:
            src = env[f.source]
            if src.shape[0] != f.slots:
                raise ValueError(
                    f"loop {self.name!r}: stack {f.name!r} adopts "
                    f"{f.source!r} with leading dim {src.shape[0]}, "
                    f"but declares {f.slots} slots")
            return torch.empty(src.shape, dtype=dtype,
                               device=self.device).copy_(src)
        if f.of == "scalar":
            shape = (f.slots,)
        elif f.length is not None:
            shape = (f.slots, f.length)
        else:
            # element shape adopted from the prototype: (n,) for a
            # vector stack, (n, s) for a matrix stack
            proto = f.like if f.like is not None else f.slot0
            shape = (f.slots,) + tuple(env[proto].shape)
        buf = torch.zeros(shape, dtype=dtype, device=self.device)
        if f.slot0 is not None:
            buf[0] = env[f.slot0]
        return buf

    def _init_fields(self, fields, env, copy=frozenset()):
        state = {}
        for f in fields:
            if f.is_stack:
                state[f.name] = self._make_stack(f, env)
            elif f.init.bare_name is not None:
                v = env[f.init.bare_name]
                state[f.name] = v.clone() if f.name in copy else v
            else:
                state[f.name] = _evaluate(f.init, env)
        return state

    @staticmethod
    def _next_state(it, state, env, copy=frozenset()):
        """Next loop state: stacks as the iteration's stores left them,
        explicit feedback edges (copied where the source is a stack),
        carry-over for the rest. `it` is a LoopSpec or an
        InnerLoopStage."""
        out = {}
        for f in it.state:
            if f.is_stack:
                out[f.name] = env[f.name]
            elif f.name in it.feedback:
                v = env[it.feedback[f.name]]
                out[f.name] = v.clone() if f.name in copy else v
            else:
                out[f.name] = state[f.name]
        return out

    def _init_state(self, operands):
        env = self._run_stages(self.lir.setup, dict(operands))
        # loop-invariant setup values are read by every iteration
        self._setup_env = env
        state = self._init_fields(self.lir.lspec.state, env)
        stop = self.lir.lspec.stop
        scale = (env[stop.scale] if isinstance(stop.scale, str)
                 else stop.scale)
        return state, env[stop.init_metric], scale

    def _body_env(self, state, threshold):
        env = dict(self._setup_env)
        env.update(state)
        # reserved name: cond predicates can express early exits
        # against the driver's stop threshold (tol * scale)
        env["threshold"] = threshold
        return self._run_stages(self.lir.body, env)

    def _step(self, operands, state, threshold):
        env = self._body_env(state, threshold)
        lspec = self.lir.lspec
        return (self._next_state(lspec, state, env,
                                 self.lir.feedback_copy),
                env[lspec.stop.metric])

    def _guards(self):
        return self.lir.lspec.guards

    def _step_guarded(self, operands, state, threshold, k):
        """One guarded iteration: run the staged body with the loop
        counter published (so iteration-targeted fault plans fire),
        then evaluate the spec's nonfinite and breakdown guards over
        the fresh body environment, on the device."""
        with chaos.loop_iteration(k):
            env = self._body_env(state, threshold)
        lspec = self.lir.lspec
        g = lspec.guards
        fault = _code(ST.RUNNING, self.device)
        for name in g.nonfinite:
            ok = torch.isfinite(torch.as_tensor(env[name]).float()).all()
            fault = torch.where(ok, fault, ST.NONFINITE)
        for bg in g.breakdown:
            # vector sentinels (one entry per right-hand side, as in
            # block-CG's Gram diagonal) trip if ANY entry collapses.
            # Checked last so BREAKDOWN (the root cause) outranks
            # NONFINITE (its downstream symptom).
            trip = (torch.as_tensor(env[bg.value]).float().abs()
                    < bg.below).any()
            fault = torch.where(trip, ST.BREAKDOWN, fault)
        return (self._next_state(lspec, state, env,
                                 self.lir.feedback_copy),
                env[lspec.stop.metric], fault)

    def _solution(self, state):
        return {pub: state[src]
                for pub, src in self.lir.lspec.solution.items()}

    # -- public API -----------------------------------------------------

    def _check_operands(self, operands, lanes_of=()):
        """Operand names as declared, tensors on the loop's device, and
        scalar operands as float32 0-d tensors on it (float32 with one
        lane each where `lanes_of` batches them)."""
        kinds = self.lir.lspec.operands
        want = set(kinds)
        missing = sorted(want - set(operands))
        extra = sorted(set(operands) - want)
        if missing or extra:
            raise ValueError(
                f"loop {self.name!r}: operand mismatch "
                f"(missing {missing}, unexpected {extra}); declared "
                f"operands: {sorted(want)}")
        out = {}
        for name, value in operands.items():
            if kinds[name] == "scalar" and isinstance(value, Number):
                value = _f32(value, self.device)
            if not torch.is_tensor(value):
                raise TypeError(f"operand {name!r} must be a tensor, got "
                                f"{type(value).__name__}")
            if value.device.type != self.device.type:
                raise ValueError(
                    f"operand {name!r} lies on {value.device}, but the "
                    f"loop runs on {self.device}; move it with "
                    f".to({str(self.device)!r})")
            if kinds[name] == "scalar":
                value = value.float() if name in lanes_of else \
                    value.float().reshape(())
            out[name] = value
        return out

    def solve(self, *, tol: Optional[float] = None,
              **operands) -> SolverResult:
        """One solve; operands are the spec's declared operand names.
        `tol` overrides the spec's `while.rtol`."""
        operands = self._check_operands(operands)
        rtol = self.lir.lspec.stop.rtol if tol is None else tol
        return self._run(operands, rtol)

    def batched(self, *, tol: Optional[float] = None,
                axes: Optional[Mapping[str, Optional[int]]] = None,
                **operands) -> SolverResult:
        """Multi-RHS solve: one run of the compiled solve per lane. By
        default vector operands batch over axis 0 and matrix and scalar
        operands broadcast (the multi-right-hand-side convention);
        `axes` overrides per operand. Every result field gains a
        leading lane axis."""
        kinds = self.lir.lspec.operands
        in_axes = {n: (0 if kinds[n] == "vector" else None)
                   for n in kinds}
        in_axes.update({n: a for n, a in (axes or {}).items()
                        if n in in_axes})
        operands = self._check_operands(
            operands, lanes_of={n for n, a in in_axes.items()
                                if a is not None})
        unknown = sorted(set(axes or ()) - set(in_axes))
        if unknown:
            raise ValueError(
                f"loop {self.name!r}: axes for unknown operands "
                f"{unknown}")
        rtol = self.lir.lspec.stop.rtol if tol is None else tol
        return self._run_batched(operands, rtol, in_axes)

    def _describe_stages(self, stages, label, lines, indent="  "):
        for cs in stages:
            st = cs.stage
            if cs.tag == "let":
                exprs = ", ".join(f"{n} = {e.src}"
                                  for n, e in st.bindings)
                lines.append(f"{indent}{label} let: {exprs}")
            elif cs.tag == "program":
                desc = Program.from_ir(cs.ir).describe()
                lines.append(indent + desc.replace("\n", "\n" + indent))
            elif cs.tag == "read":
                lines.append(f"{indent}{label} read: {st.name} = "
                             f"{st.source}[{st.slot.src}]")
            elif cs.tag == "store":
                at = f", {st.at.src}" if st.at is not None else ""
                lines.append(f"{indent}{label} store: "
                             f"{st.into}[{st.slot.src}{at}] = {st.value}")
            elif cs.tag == "cond":
                lines.append(f"{indent}{label} cond: if {st.pred.src}")
                self._describe_stages(cs.then, "then", lines,
                                      indent + "  ")
                self._describe_stages(cs.orelse, "else", lines,
                                      indent + "  ")
            else:                     # nested iterate
                stop = st.stop
                if isinstance(stop, CountRule):
                    src = stop.count.src
                    if stop.count.ast[0] == "num" and \
                            float(stop.count.ast[1]).is_integer():
                        src = str(int(stop.count.ast[1]))
                    rule = f"count {src}"
                else:
                    rule = (f"{stop.metric} <= rtol * {stop.scale!r} "
                            f"(max {stop.max_iters})")
                stacks = ", ".join(f"{f.name}[{f.slots}]"
                                   for f in st.state if f.is_stack)
                lines.append(
                    f"{indent}{label} inner loop"
                    + (f" (counter {st.counter})" if st.counter else "")
                    + f": {rule}"
                    + (f" stacks: {stacks}" if stacks else ""))
                self._describe_stages(cs.body, "inner", lines,
                                      indent + "  ")

    def describe(self) -> str:
        """Stage-by-stage report: fusion plans of every compiled stage
        program, scalar-expression stages, conditionals, stack
        reads/stores, and nested loops."""
        lspec = self.lir.lspec
        lines = [f"loop program {self.name!r} mode={self.mode} "
                 f"max_iters={self.max_iters} "
                 f"stop: {lspec.stop.metric} <= rtol * "
                 f"{lspec.stop.scale!r}"]
        self._describe_stages(self.lir.setup, "setup", lines)
        self._describe_stages(self.lir.body, "body", lines)
        feedback = ", ".join(f"{k} <- {v}"
                             for k, v in lspec.feedback.items())
        if feedback:
            lines.append(f"  feedback: {feedback}")
        stacks = ", ".join(f"{f.name}[{f.slots}]"
                           for f in lspec.state if f.is_stack)
        if stacks:
            lines.append(f"  stacks (auto-feedback): {stacks}")
        return "\n".join(lines)
