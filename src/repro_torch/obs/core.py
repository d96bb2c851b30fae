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
   which no stream may be synchronized.
3. **Stdlib only at import.** The registry, the JSONL schema and the
   CLI import no torch: `concrete` and `block` import it at call time,
   so a JSONL file is readable anywhere.

Record schema (one JSON object per line):

    {"kind": "span",    "name": ..., "path": "a/b", "t": t0_s,
     "dur_s": ..., "attrs": {...}}
    {"kind": "counter", "name": ..., "n": 1, "attrs": {...}}
    {"kind": "event",   "name": ..., "t": t_s, "attrs": {...}}

Timestamps are seconds relative to the registry's creation
(perf_counter based — ordering and duration, not wall-clock dates).
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import pathlib
import threading
import time
from typing import Iterable, List, Mapping, Optional

# REPRO_TORCH_OBS_JSONL=trace.jsonl records the whole process and
# writes the file at exit
ENV_JSONL = "REPRO_TORCH_OBS_JSONL"


class Registry:
    """One process-local sink for observability records."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.records: List[dict] = []
        self.counters: dict = {}
        self._lock = threading.Lock()
        self._stack: List[str] = []          # active span names
        self._epoch = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def add(self, rec: dict) -> None:
        with self._lock:
            self.records.append(rec)

    def bump(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
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
def capture():
    """Scoped recording into a fresh registry (the previous one — and
    its enabled state — is restored on exit), so a measurement never
    mixes its records into the caller's instrumentation."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = Registry(enabled=True)
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
    __slots__ = ("_reg", "name", "attrs", "_t0", "_path")

    def __init__(self, reg: Registry, name: str, attrs: dict):
        self._reg = reg
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        reg = self._reg
        reg._stack.append(self.name)
        self._path = "/".join(reg._stack)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        reg = self._reg
        if reg._stack and reg._stack[-1] == self.name:
            reg._stack.pop()
        reg.add({"kind": "span", "name": self.name, "path": self._path,
                 "t": self._t0 - reg._epoch, "dur_s": t1 - self._t0,
                 "attrs": self.attrs})
        return False


def span(name: str, **attrs):
    """Context manager timing one region. Disabled -> shared no-op."""
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
    with _REGISTRY._lock:
        return list(_REGISTRY.records)


def concrete(values: Iterable = ()) -> bool:
    """True unless the current stream is capturing a CUDA graph: the
    guard of the timing sites, which synchronize and so must never run
    inside a capture. `values` is accepted for the reference's call
    shape; a torch tensor is always concrete."""
    import torch

    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def block(values: Iterable) -> None:
    """Wait for the device work that produced `values`, so a span times
    the work and not its launch: synchronizes the current stream of
    each CUDA device among the tensors (once per device); CPU tensors
    and host values need no wait. Never called inside a capture (the
    callers check `concrete()` first)."""
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
