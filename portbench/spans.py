"""The `spans` window of a traced run: after the traced window, the
driver runs once more for `--seconds` under `torch.profiler` (the same
activities as the traced window) and inside
`repro_torch.obs.capture(wait=False)`, so the program records its spans
and counters at the layer boundaries without waiting for the device,
on the clock of the trace's events. The window's per-layer metrics
(`metrics/issue_*_us.program.py`, `idle_in_call.program.py`,
`copies_per_call.program.py`) read it; the first of them to be read
runs it, and the run keeps it (`run.state["spans"]`).

The window runs after the run's check, so it checks its own answers
against the same limits and raises where one fails. A program whose
`obs.capture` takes no `wait` records no such spans: there the window
is not run and its metrics read nothing. Recording costs the host time
a call, so the window's timing is no end-to-end metric.
"""
from __future__ import annotations

import dataclasses
import inspect
import statistics
import sys
from typing import Dict, List, Optional

from portbench import core, spantrace, tracing

CALL = "program.call"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@dataclasses.dataclass
class SpansWindow:
    """The window's calls, its trace's events, the program's spans as
    `spantrace.Span` tuples, and the program's counters."""
    window: core.Window
    events: List[tracing.Event]
    spans: List[spantrace.Span]
    counters: Dict[str, int]


def of(run) -> Optional[SpansWindow]:
    """The run's spans window, run on the first call; None in an
    untraced run or where the program records no such spans."""
    if "spans" not in run.state:
        run.state["spans"] = measure(run)
    return run.state["spans"]


def measure(run) -> Optional[SpansWindow]:
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
    check(run, win)
    spans = [(r["name"], r["id"], r["parent"], r["start_ns"], r["end_ns"])
             for r in reg.records if r["kind"] == "span"]
    out = SpansWindow(win, tracing.events_of(prof), spans,
                      dict(reg.counters))
    print(f"portbench: spans window {describe(out)}", file=sys.stderr)
    return out


def check(run, win: core.Window) -> None:
    """The window's answers held to the run's limits; raises on a fault."""
    only = dataclasses.replace(run, windows={"spans": win})
    bad = [(name, v, lim) for name, v, lim in run.system.check(only)
           if not v <= lim]
    if bad or win.failed:
        raise RuntimeError(f"the spans window's answers fail their check: "
                           f"{bad}, {win.failed} calls failed")
    win.answers.clear()


def describe(w: SpansWindow) -> str:
    """For the log: the window's idle share, its calls' median length
    and device copies a call, and the clock's agreement: how many of
    the trace's launches and copies lie inside the spans that issue
    them, and the synchronisations between the first call and the last."""
    calls = [(a, b) for n, _, _, a, b in w.spans if n == CALL]
    if not calls or not w.events:
        return f"{w.window.calls} calls, {len(calls)} {CALL} spans"
    lo, hi = spantrace.window_of(w.events)
    busy = sum(b - a for a, b in tracing.union(
        (a, b) for _, dev, a, b in w.events if dev))
    copies = sum(1 for n, dev, _, _ in w.events
                 if dev and n.startswith("Memcpy"))
    first, last = min(a for a, _ in calls), max(b for _, b in calls)
    launch = spantrace.inside(w.events, w.spans, "cuLaunchKernel",
                              "window.launch")
    upload = spantrace.inside(w.events, w.spans, "cudaMemcpyAsync",
                              "window.scalars")
    return (f"{w.window.calls} calls, {len(w.spans)} spans; idle "
            f"{100.0 * (1.0 - busy / (hi - lo))}% of {(hi - lo) / 1e9} s; "
            f"{CALL} median "
            f"{statistics.median(b - a for a, b in calls) / 1e3} us; "
            f"device copies a call {copies / len(calls)}; launches inside "
            f"window.launch {launch[0]}/{launch[1]}, copies inside "
            f"window.scalars {upload[0]}/{upload[1]}; synchronisations "
            f"between the first call and the last "
            f"{spantrace.between(w.events, first, last, SYNCS)}")


def median_us(run, name: str, self_time: bool = True) -> Optional[float]:
    """The median over the window's calls of the time of the call's
    spans named `name` (their self time, or their duration), in
    microseconds; None where no call holds such a span."""
    w = of(run)
    if w is None:
        return None
    value = (spantrace.self_ns(w.spans) if self_time else
             {sid: b - a for _, sid, _, a, b in w.spans})
    per = spantrace.per_call(w.spans, CALL, name, value)
    return statistics.median(per) / 1e3 if per else None
