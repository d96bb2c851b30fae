"""The arithmetic that joins the program's spans to a profiler trace
taken around them: each span's self time, the spans of one call, and
the device's idle time under the spans of one name.

Spans are plain tuples (name, id, parent id or None, start_ns, end_ns),
as `repro_torch.obs` records them, on the clock of the trace's events
(`portbench.tracing.Event`), so the arithmetic is tested without the
program or a card.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import tracing

Span = Tuple[str, int, Optional[int], int, int]


def self_ns(spans: Sequence[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less the part of it
    that its children's intervals cover (their union, clipped to it)."""
    kids: Dict[int, List[Tuple[int, int]]] = {}
    for _, _, parent, a, b in spans:
        if parent is not None:
            kids.setdefault(parent, []).append((a, b))
    out = {}
    for _, sid, _, a, b in spans:
        covered = sum(min(y, b) - max(x, a)
                      for x, y in tracing.union(kids.get(sid, ()))
                      if min(y, b) > max(x, a))
        out[sid] = (b - a) - covered
    return out


def calls_of(spans: Sequence[Span], root: str) -> Dict[int, int]:
    """The id of the call each span belongs to: its nearest ancestor (or
    itself) named `root`. Spans outside every such span are left out."""
    up = {sid: (name, parent) for name, sid, parent, _, _ in spans}
    out: Dict[int, int] = {}
    for sid in up:
        at = sid
        while at in up:
            name, parent = up[at]
            if name == root:
                out[sid] = at
                break
            at = parent
    return out


def per_call(spans: Sequence[Span], root: str, name: str,
             value: Dict[int, int]) -> List[int]:
    """For each call (span named `root`) holding a span named `name`,
    the sum of `value` over those spans, in the calls' order."""
    call = calls_of(spans, root)
    sums: Dict[int, int] = {}
    for n, sid, _, _, _ in spans:
        if n == name and sid in call:
            sums[call[sid]] = sums.get(call[sid], 0) + value[sid]
    order = sorted((a, sid) for n, sid, _, a, _ in spans if n == root)
    return [sums[sid] for _, sid in order if sid in sums]


def window_of(events: Sequence[tracing.Event]) -> Tuple[int, int]:
    """The trace's window: the first event's start to the last's end."""
    if not events:
        raise ValueError("the trace holds no event")
    return (min(a for _, _, a, _ in events),
            max(b for _, _, _, b in events))


def idle_under(events: Sequence[tracing.Event], spans: Sequence[Span],
               name: str) -> int:
    """Device-idle nanoseconds of the trace's window whose gap middle
    lies inside a span named `name`."""
    lo, hi = window_of(events)
    busy = tracing.union((a, b) for _, dev, a, b in events if dev)
    under = tracing.union((a, b) for n, _, _, a, b in spans if n == name)
    starts = [a for a, _ in under]
    out = 0
    for a, b in tracing.gaps(busy, lo, hi):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and under[i][1] >= mid:
            out += b - a
    return out


def inside(events: Sequence[tracing.Event], spans: Sequence[Span],
           prefix: str, name: str) -> Tuple[int, int]:
    """(host events whose name starts with `prefix` that lie wholly
    inside a span named `name`, all such events)."""
    under = tracing.union((a, b) for n, _, _, a, b in spans if n == name)
    starts = [a for a, _ in under]
    hits = total = 0
    for n, dev, a, b in events:
        if dev or not n.startswith(prefix):
            continue
        total += 1
        i = bisect.bisect_right(starts, a) - 1
        hits += i >= 0 and under[i][1] >= b
    return hits, total


def between(events: Iterable[tracing.Event], lo: int, hi: int,
            prefixes: Tuple[str, ...]) -> int:
    """Host events named with one of `prefixes` that start in (lo, hi)."""
    return sum(1 for n, dev, a, _ in events
               if not dev and lo < a < hi and n.startswith(prefixes))
