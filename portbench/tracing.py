"""The arithmetic that turns a profiler trace into the device metrics,
copied from `tools/trace_programs.py`: device busy time is the union of
the device operations' intervals, the idle share is one less busy over
the window, and each idle gap is named by the host event (on the card:
the CUDA runtime call) that covers it.

The harness traces its window and nothing else, after a synchronisation,
so the traced window is the span of the trace's events, from the first
one's start to the last one's end. Events are plain tuples (name,
on_device, start_ns, end_ns), so the arithmetic is tested without a
card.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence, Tuple

Event = Tuple[str, bool, int, int]
# device operations that copy or fill memory: busy time, but no kernel
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
# host events scanned back from a gap for the innermost one covering it
SCAN = 4000
UNCOVERED = "host outside any traced call"


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals as sorted, disjoint intervals."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def gaps(merged: Sequence[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def summarize(events: Sequence[Event]) -> dict:
    """Busy and window seconds, kernels, the device operations that took
    most time and the longest idle gaps by host activity, over the span
    of `events`. Raises when the trace holds no event."""
    if not events:
        raise ValueError("the trace holds no event")
    lo = min(a for _, _, a, _ in events)
    hi = max(b for _, _, _, b in events)
    device = [(name, a, b) for name, dev, a, b in events if dev]
    merged = union((a, b) for _, a, b in device)
    busy = sum(b - a for a, b in merged)
    by_op: dict = {}
    for name, a, b in device:
        by_op[name] = by_op.get(name, 0) + (b - a)
    kernels = sum(1 for name, _, _ in device
                  if not name.startswith(NOT_KERNELS))
    host = sorted((a, b, name) for name, dev, a, b in events if not dev)
    idle = name_gaps(gaps(merged, lo, hi), host)
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": kernels,
        "device_ops": top(by_op),
        "idle_gaps": top(idle),
    }


def name_gaps(idle: Sequence[Tuple[int, int]],
              host: Sequence[Tuple[int, int, str]]) -> dict:
    """Idle nanoseconds by the innermost host event covering each gap's
    middle (host events sorted by start); gaps no event covers are
    host time outside every traced call (Python, on the card)."""
    starts = [a for a, _, _ in host]
    out: dict = {}
    for a, b in idle:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = UNCOVERED
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0) + (b - a)
    return out


def top(ns_by_name: dict) -> list:
    """The TOP largest entries as [name, seconds], largest first."""
    rows = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:120], ns / 1e9] for name, ns in rows]


def events_of(prof) -> List[Event]:
    """(name, on_device, start_ns, end_ns) for every event of a finished
    `torch.profiler.profile`, from its kineto results where the version
    offers them, else from its function events."""
    from torch.autograd import DeviceType

    out: List[Event] = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        for e in results.events():
            start = e.start_ns()
            out.append((e.name(), e.device_type() != DeviceType.CPU,
                        start, start + e.duration_ns()))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type != DeviceType.CPU,
                    int(e.time_range.start * 1e3),
                    int(e.time_range.end * 1e3)))
    return out
