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

On the card, a `LoopProgram`'s guarded iteration runs as one CUDA graph
(`_LoopGraph`; ROADMAP Queue 4 item 4.4, "item 18"): the staged body,
the nonfinite and breakdown guards, the stall and best update, the
history write and the status chain, captured once and replayed once an
iteration, so the host's work between two stop reads is one graph
launch. The graph reads
its loop state from static buffers on the device (the state fields, the
stall count, the best metric, the threshold and divergence limit, the
setup values the body reads and an iteration counter) and writes the
next values back into them; the history write and the MAX_ITERS code
take the counter, so no host int is baked into the graph. It engages
(`graph_engages`) on a CUDA device, for a body with no `cond` stage and
no nested loop (those read the device on the host inside the body), a
lowering with no fault plan, and a registry that does not wait for the
device (a waiting span synchronises, which a capture forbids); any
other solve runs the same iteration eagerly. Each program keeps a few
graphs (`GRAPHS`), keyed on the address, shape, stride and dtype of
each matrix operand the body reads and on the shapes of what it
copies. A solve whose key is new runs its first iteration eagerly,
which warms the kernels' JIT, their tickets and the allocator, and
captures at its second; a solve that stops after one iteration captures
nothing. A solve copies its results out of the static buffers, so a
later replay never writes into a returned tensor. The answers are
bitwise the eager loop's: the same kernels in the same order.

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
those values from the device only while recording. The port adds, while
recording, a `loop.iter` span per outer iteration, holding a
`loop.stop` span around the host's read of the stop rule (where the
host waits for the device), a `loop.stage` span per stage a
`LoopProgram` runs (setup, body, branches and nested loops; attributes
built once per stage), and
the `loop.iterations` counter, bumped once per solve by its iterations;
on the graph path `loop.graph_captures`, bumped by each capture, and
`loop.graph_replays`, bumped once per solve by its replays (0 where it
stopped after its eager first iteration). A replayed iteration keeps
its `loop.iter` and `loop.stop` spans and runs no stage span.
None of them waits for the device or reads it. The guarded step of
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

import collections
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
# the CUDA graphs a LoopProgram keeps, one a key; the least recently
# used goes first
GRAPHS = 4


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


@dataclasses.dataclass
class _Carry:
    """What the guarded loop carries from one iteration to the next, on
    the device: the loop state, the last metric, its best, the
    iterations since a new best and the status."""
    state: dict
    res: torch.Tensor
    best: torch.Tensor
    stall: torch.Tensor
    status: torch.Tensor

    def tensors(self) -> list:
        """Every field, the state's by name."""
        return [*(self.state[n] for n in sorted(self.state)), self.res,
                self.best, self.stall, self.status]


class _LoopGraph:
    """One guarded iteration of a `LoopProgram` captured as a CUDA
    graph, and the static buffers it reads and writes: the carry, the
    limits (threshold, the stall test's factor, the divergence limit or
    None), the history, the iteration count `k` (0-d int64) and the
    setup values the body reads that are copied (`copied`; a matrix
    operand is read where it lies). A replay runs one iteration from the
    buffers and leaves the next carry and count in them."""

    def __init__(self, c: _Carry, limits, hist, copied: Mapping):
        def static(v):
            return None if v is None else torch.empty(
                v.shape, dtype=v.dtype, device=v.device)
        self.carry = _Carry({n: static(v) for n, v in c.state.items()},
                            static(c.res), static(c.best), static(c.stall),
                            static(c.status))
        self.limits = tuple(static(v) for v in limits)
        self.hist = static(hist)
        self.k = torch.zeros((), dtype=torch.int64, device=hist.device)
        self.copied = {n: static(v) for n, v in copied.items()}
        self.graph = None

    def _buffers(self, c, limits, hist, env) -> list:
        return [*c.tensors(), *(v for v in limits if v is not None), hist,
                *(env[n] for n in sorted(self.copied))]

    def load(self, c: _Carry, limits, hist, env, k: int) -> None:
        """Copy a solve's carry, limits, history and setup values
        (`env`) into the buffers, and its iteration count."""
        for dst, src in zip(
                self._buffers(self.carry, self.limits, self.hist,
                              self.copied),
                self._buffers(c, limits, hist, env)):
            dst.copy_(src)
        self.k.fill_(k)

    def step(self, iterate) -> None:
        """`iterate(carry, limits, hist, k)`, which gives the next carry
        and k + 1, over the buffers, and its results copied back into
        them: what a replay runs."""
        nxt, k = iterate(self.carry, self.limits, self.hist, self.k)
        pairs = [(d, s) for d, s in zip(self.carry.tensors() + [self.k],
                                        nxt.tensors() + [k])
                 if s is not d]
        # a value that lies in a buffer written below (a field fed back
        # from another field) is copied out first
        mine = {d.untyped_storage().data_ptr() for d, _ in pairs}
        pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in mine
                  else s) for d, s in pairs]
        for d, s in pairs:
            d.copy_(s)

    def capture(self, iterate) -> None:
        """Capture `step(iterate)` on a side stream: nothing runs until
        the first replay."""
        dev = self.k.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.step(iterate)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()

    def results(self):
        """The carry and the history, copied out of the buffers."""
        c = self.carry
        return (_Carry({n: v.clone() for n, v in c.state.items()},
                       c.res.clone(), c.best.clone(), c.stall.clone(),
                       c.status.clone()),
                self.hist.clone())


def _body_reads(lir) -> set:
    """Every name that a loop body's stages, guards, stop metric and
    feedback edges read (a `cond` or nested loop left out: such a body
    never takes the graph path)."""
    lspec = lir.lspec
    names = set(lspec.feedback.values()) | {lspec.stop.metric}
    for cs in lir.body:
        st = cs.stage
        if cs.tag == "let":
            for _, expr in st.bindings:
                names |= expr.names
        elif cs.tag == "program":
            names |= set(cs.inputs.values())
        elif cs.tag == "read":
            names |= {st.source} | st.slot.names
        elif cs.tag == "store":
            names |= {st.into, st.value} | st.slot.names
            if st.at is not None:
                names |= st.at.names
    if lspec.guards is not None:
        names |= set(lspec.guards.nonfinite)
        names |= {b.value for b in lspec.guards.breakdown}
    return names


def graph_engages(lir, device: torch.device, waiting: bool) -> bool:
    """Whether a lowered loop's guarded iterations replay a CUDA graph:
    on a CUDA device, for a body with no `cond` stage and no nested loop
    (both read the device on the host inside the body), a lowering
    with no fault plan (`guard.chaos.wrap_program_fn`) and a registry
    that does not wait for the device (`obs.waiting()`: a waiting span
    synchronises, which a capture forbids)."""
    return (device.type == "cuda" and not waiting
            and all(cs.tag not in ("cond", "loop") for cs in lir.body)
            and not any(getattr(cs.ir.fn, "fault", None) is not None
                        for cs in lir.setup + lir.body
                        if cs.tag == "program"))


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
        # the loop spans' attributes, built once: an iteration's spans
        # build no dict
        self._loop_attrs = {"program": self.name, "mode": mode}

    # -- subclass hooks -------------------------------------------------

    def _init_state(self, operands):
        raise NotImplementedError

    def _step(self, operands, state, threshold):
        raise NotImplementedError

    def _solution(self, state):
        raise NotImplementedError

    def _guards(self):
        """The GuardSpec of the guarded loop (`LoopProgram`'s
        `_solve_guarded`), or None for the ungated loop (no guards
        section)."""
        return None

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
        timed = obs.enabled()
        k = 0
        running = k < self.max_iters and bool(res > threshold)
        while running:
            with self._loop_span("loop.iter", timed):
                state, res = self._step(operands, state, threshold)
                res = _f32(res, self.device)
                hist[k + 1] = res
                k += 1
                with self._loop_span("loop.stop", timed):
                    running = k < self.max_iters and bool(res > threshold)
        if timed:
            obs.counter("loop.iterations", k)
        return dict(state=state, iterations=k, residual=res, history=hist,
                    converged=res <= threshold, status=None)

    def _loop_span(self, name, timed):
        """A `loop.iter` or `loop.stop` span while recording, else the
        shared no-op."""
        return obs.span_with(name, self._loop_attrs) if timed \
            else obs.NULL_SPAN

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
            if obs.waiting() and obs.concrete():
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
            if obs.waiting() and obs.concrete():
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
        # the CUDA graphs of the guarded iteration, by key, least
        # recently used first; the setup values the body reads, and
        # those it reads where they lie (matrix operands)
        self._graphs = collections.OrderedDict()
        self._reads = sorted(
            _body_reads(lir) & set(lir.setup_kinds)
            - set(lir.state_kinds) - {"threshold"})
        self._in_place = {n for n in self._reads
                          if lir.lspec.operands.get(n) == "matrix"}
        # each stage's `loop.stage` attributes, built once
        self._stage_attrs = {}
        self._label_stages(lir.setup)
        self._label_stages(lir.body)

    def _label_stages(self, stages):
        for cs in stages:
            label = cs.ir.spec.name if cs.tag == "program" else cs.tag
            self._stage_attrs[id(cs)] = {"program": self.name,
                                         "mode": self.mode,
                                         "stage": label}
            for inner in (cs.then, cs.orelse, cs.body):
                if inner:
                    self._label_stages(inner)

    # -- spec-driven driver hooks ---------------------------------------

    def _run_stages(self, stages, env):
        if not obs.enabled():
            for cs in stages:
                self._run_stage(cs, env)
            return env
        for cs in stages:
            with obs.span_with("loop.stage", self._stage_attrs[id(cs)]):
                self._run_stage(cs, env)
        return env

    def _run_stage(self, cs, env):
        """One stage, its results bound into `env`."""
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

    def _solve_guarded(self, operands, tol, guards):
        """The guarded loop: the status is an int8 on the device, and
        the loop runs while it reads RUNNING (`_iterate` computes it).
        Where the graph path engages (`_graph_key`), the iterations
        replay the key's graph: from the first where the program has
        one, else from the second, after its capture."""
        dev = self.device
        state, res0, threshold, hist = self._start(operands, tol)
        div_limit = None
        if guards.divergence is not None:
            div_limit = _f32(guards.divergence, dev) * torch.clamp_min(
                res0, _TINY)
        limits = (threshold, _f32(1.0 - guards.min_drop, dev), div_limit)
        # codes enter as kernel arguments (torch.full, torch.where on a
        # Python int): a tensor built from a host value would copy it
        # from pageable memory and make the host wait for the device
        status = _code(ST.RUNNING, dev)
        status = torch.where(res0 <= threshold, ST.CONVERGED, status)
        status = torch.where(torch.isfinite(res0), status, ST.NONFINITE)
        if self.max_iters <= 0:     # degenerate budget: never iterate
            status = torch.where(status == ST.RUNNING, ST.MAX_ITERS,
                                 status)
        c = _Carry(state, res0, res0,
                   torch.zeros((), dtype=torch.int32, device=dev), status)

        def iterate(c, limits, hist, k):
            return self._iterate(operands, c, limits, hist, k,
                                 guards.stagnation)

        timed = obs.enabled()
        key = self._graph_key(state)
        graph = self._graphs.get(key) if key is not None else None
        if graph is not None:
            self._graphs.move_to_end(key)
            graph.load(c, limits, hist, self._setup_env, 0)
        k = replays = 0
        running = int(status) == ST.RUNNING     # waits for the setup
        while running:
            with self._loop_span("loop.iter", timed):
                if graph is None and key is not None and k:
                    graph = self._capture(key, c, limits, hist, iterate,
                                          timed)
                    graph.load(c, limits, hist, self._setup_env, k)
                if graph is None:
                    c, k = iterate(c, limits, hist, k)
                    status = c.status
                else:
                    graph.replay()
                    k += 1
                    replays += 1
                    status = graph.carry.status
                with self._loop_span("loop.stop", timed):
                    # the iteration's one sync
                    running = int(status) == ST.RUNNING
        if graph is not None:
            c, hist = graph.results()
        if timed:
            obs.counter("loop.iterations", k)
            if key is not None:
                obs.counter("loop.graph_replays", replays)
        return dict(state=c.state, iterations=k, residual=c.res,
                    history=hist, converged=c.status == ST.CONVERGED,
                    status=c.status)

    def _iterate(self, operands, c, limits, hist, k, window):
        """One guarded iteration from the carry `c` after `k` iterations
        (a host int, or a graph's 0-d int64 count on the device): the
        step, the history write and the status chain, which classifies
        the new metric as the reference does (later writes win):
        MAX_ITERS and STAGNATED, then DIVERGED, CONVERGED, NONFINITE and
        last the in-body fault, whose BREAKDOWN already outranks
        NONFINITE. Returns the next carry and k + 1."""
        dev = self.device
        threshold, keep, div_limit = limits
        state, res, fault = self._step_guarded(operands, c.state,
                                               threshold, k)
        res = _f32(res, dev)
        k = k + 1
        if torch.is_tensor(k):
            hist.index_copy_(0, k.reshape(1), res.reshape(1))
            status = _code(ST.RUNNING, dev).masked_fill(
                k >= self.max_iters, ST.MAX_ITERS)
        else:
            hist[k] = res
            status = _code(ST.MAX_ITERS if k >= self.max_iters
                           else ST.RUNNING, dev)
        stall = torch.where(res < c.best * keep, 0, c.stall + 1)
        best = torch.minimum(c.best, res)
        if window is not None:
            status = torch.where(stall >= window, ST.STAGNATED, status)
        if div_limit is not None:
            status = torch.where(res > div_limit, ST.DIVERGED, status)
        status = torch.where(res <= threshold, ST.CONVERGED, status)
        status = torch.where(torch.isfinite(res), status, ST.NONFINITE)
        if fault is not None:
            status = torch.where(fault != ST.RUNNING, fault, status)
        return _Carry(state, res, best, stall, status), k

    def _graph_key(self, state):
        """This solve's graph key, or None where the graph path does not
        engage: `graph_engages`, and every state field a tensor. The key
        holds each setup value the body reads: a matrix operand's
        address, shape, stride and dtype, a copied tensor's shape and
        dtype, a host number itself; and each state field's shape and
        dtype."""
        if not graph_engages(self.lir, self.device, obs.waiting()):
            return None
        key = []
        for n in self._reads:
            v = self._setup_env[n]
            if not torch.is_tensor(v):
                key.append((n, v))
            elif n in self._in_place:
                key.append((n, v.data_ptr(), tuple(v.shape), v.stride(),
                            v.dtype))
            else:
                key.append((n, tuple(v.shape), v.dtype))
        for n, v in state.items():
            if not torch.is_tensor(v):
                return None
            key.append((n, tuple(v.shape), v.dtype))
        return tuple(key)

    def _capture(self, key, c, limits, hist, iterate, timed):
        """A new graph for `key`, shaped as this solve's carry, captured
        with the body reading the setup values from its buffers; the
        least recently used graph goes past `GRAPHS`."""
        env = self._setup_env
        graph = _LoopGraph(c, limits, hist, {
            n: env[n] for n in self._reads
            if n not in self._in_place and torch.is_tensor(env[n])})
        self._setup_env = {n: graph.copied.get(n, env[n])
                           for n in self._reads}
        try:
            graph.capture(iterate)
        finally:
            self._setup_env = env
        if len(self._graphs) >= GRAPHS:
            self._graphs.popitem(last=False)
        self._graphs[key] = graph
        if timed:
            obs.counter("loop.graph_captures")
        return graph

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
