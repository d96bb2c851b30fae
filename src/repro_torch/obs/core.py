"""Process-local observability registry: spans, counters, events.

The port's compile/run pipeline reports here — lowering passes,
program-cache hits, fusion decisions, generated-kernel executions,
solver loop builds and convergence results, the escalation ladder's
attempts — as flat, structured records that export to JSONL
(`python -m repro_torch.obs` summarizes, traces and diffs the files).
The registry, the record schema and the record names are the reference
package's; the registry itself is the port's own, so recording in one
package never shows in the other.

Design constraints, in priority order:

1. **Zero overhead when disabled** (the default). Every recording
   entrypoint starts with one attribute check against the process
   registry; `span()` returns the shared `NULL_SPAN` without touching
   the clock. Nothing is allocated, nothing is written, nothing waits
   for the device.
2. **Capture-safe when enabled.** A `kernel.group` span blocks on the
   group's outputs so it times the work, not the launch; it is taken
   only where `concrete()` holds, i.e. outside a CUDA-graph capture, in
   which no stream may be synchronized. A registry made by
   `capture(wait=False)` never waits: `block` returns at once and no
   site synchronizes, so its spans time the host's issue of the work
   and recording leaves the device's queue as it would be.
3. **Lean when enabled.** A span costs two clock reads, an id and two
   list operations: it is kept as its own object, with no lock and no
   dict built, and becomes a record dict only when the records are
   read.
4. **Stdlib only at import.** The registry, the JSONL schema and the
   CLI import no torch: `concrete` and `block` import it at call time,
   so a JSONL file is readable anywhere.

Record schema (one JSON object per line):

    {"kind": "span",    "name": ..., "path": "a/b", "t": t0_s,
     "dur_s": ..., "attrs": {...}, "id": 7, "parent": 3,
     "start_ns": ..., "end_ns": ...}
    {"kind": "counter", "name": ..., "n": 1, "attrs": {...}}
    {"kind": "event",   "name": ..., "t": t_s, "attrs": {...}}

`t` and `dur_s` are seconds from the registry's creation. A span's
`start_ns` and `end_ns` are integer nanoseconds of `time.time_ns()`,
the Unix-epoch clock on which `torch.profiler` stamps its events (the
CUDA runtime's records included), so spans line up with a device trace
taken in the same process. `id` numbers the registry's spans from 1 in
the order they begin; `parent` is the id of the span open around it
when it began (None at the top), so the spans of one call reach the id
of their root.
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import pathlib
import threading
import time
from typing import Iterable, List, Mapping, Optional

# REPRO_TORCH_OBS_JSONL=trace.jsonl records the whole process and
# writes the file at exit
ENV_JSONL = "REPRO_TORCH_OBS_JSONL"
_clock = time.time_ns


class Registry:
    """One process-local sink for observability records. `wait` False
    makes `block` a no-op while this registry records."""

    def __init__(self, enabled: bool = False, wait: bool = True):
        self.enabled = enabled
        self.wait = wait
        self.counters: dict = {}
        self._log: list = []         # record dicts and closed _Spans
        self._read = 0               # _log[:_read] holds dicts only
        self._lock = threading.Lock()
        self._stack: list = []       # open spans, innermost last
        self._ids = itertools.count(1).__next__
        self._epoch_ns = _clock()

    @property
    def records(self) -> List[dict]:
        """Every record in the order recorded (a span when it closes),
        each span turned into its dict the first time it is read."""
        log, n = self._log, len(self._log)
        for i in range(self._read, n):
            if type(log[i]) is _Span:
                log[i] = log[i].record(self._epoch_ns)
        self._read = n
        return log

    def now(self) -> float:
        return (_clock() - self._epoch_ns) / 1e9

    def add(self, rec: dict) -> None:
        with self._lock:
            self._log.append(rec)

    def bump(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def clear(self) -> None:
        with self._lock:
            self._log.clear()
            self._read = 0
            self.counters.clear()
            self._stack.clear()

    def export_jsonl(self, path) -> pathlib.Path:
        """Write every record as one JSON line; returns the path."""
        path = pathlib.Path(path)
        with self._lock:
            lines = [json.dumps(r, default=repr) for r in self.records]
        path.write_text("\n".join(lines) + ("\n" if lines else ""))
        return path


_REGISTRY = Registry()
_EXPORT_PATH: Optional[str] = None


def get_registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def enable(jsonl: Optional[str] = None) -> Registry:
    """Turn recording on. `jsonl` remembers a default export path for
    `export()` (and the atexit flush when activated through the
    REPRO_TORCH_OBS_JSONL environment variable)."""
    global _EXPORT_PATH
    _REGISTRY.enabled = True
    if jsonl is not None:
        _EXPORT_PATH = str(jsonl)
    return _REGISTRY


def disable() -> None:
    _REGISTRY.enabled = False


def reset() -> None:
    """Drop all accumulated records and counters (keeps enabled state)."""
    _REGISTRY.clear()


def export(path: Optional[str] = None) -> pathlib.Path:
    """Export accumulated records as JSONL to `path` (or the path given
    to `enable()`)."""
    target = path if path is not None else _EXPORT_PATH
    if target is None:
        raise ValueError(
            "no export path: pass one to export() or enable(jsonl=...)")
    return _REGISTRY.export_jsonl(target)


@contextlib.contextmanager
def capture(wait: bool = True):
    """Scoped recording into a fresh registry (the previous one — and
    its enabled state — is restored on exit), so a measurement never
    mixes its records into the caller's instrumentation. `wait` False:
    no site waits for the device while it records (`block` returns at
    once), so the spans time the host's issue and change no timing."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = Registry(enabled=True, wait=wait)
    try:
        yield _REGISTRY
    finally:
        _REGISTRY = prev


# ---------------------------------------------------------------------------
# Recording entrypoints
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared no-op span: what `span()` hands out when disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def null_span() -> _NullSpan:
    return NULL_SPAN


class _Span:
    __slots__ = ("_reg", "name", "attrs", "id", "parent", "path",
                 "start_ns", "end_ns")

    def __init__(self, reg: Registry, name: str, attrs: Mapping):
        self._reg = reg
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        reg = self._reg
        stack = reg._stack
        if stack:
            up = stack[-1]
            self.parent = up.id
            self.path = up.path + "/" + self.name
        else:
            self.parent = None
            self.path = self.name
        self.id = reg._ids()
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        reg = self._reg
        stack = reg._stack
        if stack and stack[-1] is self:
            stack.pop()
        reg._log.append(self)        # atomic under the GIL: no lock
        return False

    def record(self, epoch_ns: int) -> dict:
        return {"kind": "span", "name": self.name, "path": self.path,
                "t": (self.start_ns - epoch_ns) / 1e9,
                "dur_s": (self.end_ns - self.start_ns) / 1e9,
                "attrs": dict(self.attrs), "id": self.id,
                "parent": self.parent, "start_ns": self.start_ns,
                "end_ns": self.end_ns}


NO_ATTRS: Mapping = {}


def span(name: str, **attrs):
    """Context manager timing one region. Disabled -> shared no-op."""
    reg = _REGISTRY
    if not reg.enabled:
        return NULL_SPAN
    return _Span(reg, name, attrs)


def span_with(name: str, attrs: Mapping = NO_ATTRS):
    """`span` for a hot path: `attrs` is a mapping the site built once
    and never changes (the record copies it when read), so taking the
    span builds no dict."""
    reg = _REGISTRY
    if not reg.enabled:
        return NULL_SPAN
    return _Span(reg, name, attrs)


def counter(name: str, n: int = 1, **attrs) -> None:
    """Bump a named counter (aggregated in the registry AND appended as
    a record, so JSONL files stay self-contained)."""
    reg = _REGISTRY
    if not reg.enabled:
        return
    reg.bump(name, n)
    rec = {"kind": "counter", "name": name, "n": n}
    if attrs:
        rec["attrs"] = attrs
    reg.add(rec)


def event(name: str, **attrs) -> None:
    """Record one structured event."""
    reg = _REGISTRY
    if not reg.enabled:
        return
    reg.add({"kind": "event", "name": name, "t": reg.now(),
             "attrs": attrs})


def counters() -> Mapping[str, int]:
    """Snapshot of the aggregated counters."""
    return dict(_REGISTRY.counters)


def records() -> List[dict]:
    """Snapshot of the raw records."""
    reg = _REGISTRY
    with reg._lock:
        return list(reg.records)


def concrete(values: Iterable = ()) -> bool:
    """True unless the current stream is capturing a CUDA graph: the
    guard of the timing sites, which synchronize and so must never run
    inside a capture. `values` is accepted for the reference's call
    shape; a torch tensor is always concrete."""
    import torch

    # no stream captures before CUDA is initialised; the query is the
    # cheaper test of the two, taken on every recorded call
    return not (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())


def waiting() -> bool:
    """True while recording into a registry that waits for the device:
    the guard of the sites that call `block`."""
    reg = _REGISTRY
    return reg.enabled and reg.wait


def block(values: Iterable) -> None:
    """Wait for the device work that produced `values`, so a span times
    the work and not its launch: synchronizes the current stream of
    each CUDA device among the tensors (once per device); CPU tensors
    and host values need no wait. Returns at once in a registry made by
    `capture(wait=False)`. Never called inside a capture (the callers
    check `concrete()` first)."""
    if not _REGISTRY.wait:
        return
    import torch

    seen = set()
    for v in values:
        if torch.is_tensor(v) and v.is_cuda and v.device not in seen:
            seen.add(v.device)
            torch.cuda.current_stream(v.device).synchronize()


_env_path = os.environ.get(ENV_JSONL)
if _env_path:
    enable(jsonl=_env_path)
    # the path is bound now: the module name is deleted below (the
    # reference's handler looks it up at exit, and raises NameError)
    atexit.register(lambda path=_env_path: _REGISTRY.export_jsonl(path))
del _env_path
