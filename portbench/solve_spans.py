"""The loop-driver window of a traced solve run: after the traced window
and the check, the driver runs once more for `--seconds` under
`torch.profiler` (the traced window's activities) and inside
`repro_torch.obs.capture(wait=False)`, so that the program records its
loop spans (`loop.iter`, `loop.stop`, `loop.stage`) and its
`loop.iterations` counter on the clock of the trace's events. The
solve cell's span metrics (`metrics/*.solve.py`) read it; the first of
them to be read runs it, and the run keeps it
(`run.state["solve_spans"]`).

It is `spans.py`'s window with two things more: each span's attributes
(a `loop.stage` span names its stage program) and each trace event's
correlation id, which ties a device kernel to the host call that
launched it. Its answers are held to the run's limits (`spans.check`).
A program that records no `loop.iter` span, as one without the loop
spans, gives no window, and its metrics read nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
import inspect
import statistics
import sys
from typing import Dict, List, Optional

from portbench import core, spans, spantrace, tracing

ITER = "loop.iter"
STOP = "loop.stop"
STAGE = "loop.stage"
ITERATIONS = "loop.iterations"
PRECOND = "pcg_precond"              # the preconditioner's stage program
LAUNCHES = ("cuLaunch", "cudaLaunch")


@dataclasses.dataclass
class SolveWindow:
    """The window's solves, its trace's events with their correlation
    ids (`correlation[j]` of `events[j]`), the program's spans with
    each one's attributes by id, and its counters."""
    window: core.Window
    events: List[tracing.Event]
    correlation: List[int]
    spans: List[spantrace.Span]
    attrs: Dict[int, dict]
    counters: Dict[str, int]

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]


def of(run) -> Optional[SolveWindow]:
    """The run's loop window, run on the first call; None in an
    untraced run or where the program records no loop spans."""
    if "solve_spans" not in run.state:
        run.state["solve_spans"] = measure(run)
    return run.state["solve_spans"]


def measure(run) -> Optional[SolveWindow]:
    if not run.trace:
        return None
    from repro_torch import obs
    from torch.profiler import ProfilerActivity, profile

    if "wait" not in inspect.signature(obs.capture).parameters:
        return None
    run.driver.warm(run)        # the program again, after the check
    core.sync(run.device)
    acts = [ProfilerActivity.CUDA if run.device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with obs.capture(wait=False) as reg:
            win = run.driver.window(run, run.seconds)
    spans.check(run, win)
    recs = [r for r in reg.records if r["kind"] == "span"]
    if not any(r["name"] == ITER for r in recs):
        return None
    events, corr = events_of(prof)
    out = SolveWindow(
        win, events, corr,
        [(r["name"], r["id"], r["parent"], r["start_ns"], r["end_ns"])
         for r in recs],
        {r["id"]: r["attrs"] for r in recs}, dict(reg.counters))
    print(f"portbench: solve spans window {describe(out)}",
          file=sys.stderr)
    return out


def events_of(prof):
    """The finished profile's events as `tracing.Event` tuples, and
    each one's correlation id (0 where it has none)."""
    from torch.autograd import DeviceType

    events, corr = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        events.append((e.name(), e.device_type() != DeviceType.CPU, start,
                       start + e.duration_ns()))
        corr.append(int(e.correlation_id()))
    return events, corr


def iterations(w: SolveWindow) -> int:
    return int(w.counters.get(ITERATIONS, 0))


def busy_ns(w: SolveWindow) -> int:
    return sum(b - a for a, b in tracing.union(
        (a, b) for _, dev, a, b in w.events if dev))


def precond_device_ns(w: SolveWindow) -> Optional[int]:
    """Device time of the kernels launched inside the preconditioner's
    `loop.stage` spans, tied to their launches by correlation id; None
    where the window holds no such launch, or no kernel answers one."""
    under = tracing.union((a, b) for _, sid, _, a, b in w.named(STAGE)
                          if w.attrs[sid].get("stage") == PRECOND)
    starts = [a for a, _ in under]
    launched = set()
    for (name, dev, a, b), c in zip(w.events, w.correlation):
        if dev or not c or not name.startswith(LAUNCHES):
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and under[i][1] >= b:
            launched.add(c)
    if not launched:
        return None
    hit = [(a, b) for (name, dev, a, b), c in zip(w.events, w.correlation)
           if dev and c in launched and not name.startswith(
               tracing.NOT_KERNELS)]
    if not hit:
        return None
    return sum(b - a for a, b in tracing.union(hit))


def describe(w: SolveWindow) -> str:
    """For the log: solves, iterations, spans, the window's idle share,
    and the median `loop.iter` and `loop.stop` span."""
    its = [b - a for _, _, _, a, b in w.named(ITER)]
    stops = [b - a for _, _, _, a, b in w.named(STOP)]
    if not its or not w.events:
        return f"{w.window.calls} solves, {len(its)} {ITER} spans"
    lo, hi = spantrace.window_of(w.events)
    return (f"{w.window.calls} solves, {iterations(w)} iterations, "
            f"{len(w.spans)} spans; idle "
            f"{100.0 * (1.0 - busy_ns(w) / (hi - lo))}% of "
            f"{(hi - lo) / 1e9} s; {ITER} median "
            f"{statistics.median(its) / 1e3} us, {STOP} median "
            f"{statistics.median(stops) / 1e3} us")
