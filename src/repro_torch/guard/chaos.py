"""Deterministic fault injection for dataflow programs and files.

`FaultPlan` describes ONE fault: which stage program to poison
(`program`, by spec name, `"*"` for any), which of its outputs
(`output`, None = all), at which outer-loop iteration (`iteration`,
None = every call), and how (`kind`: nan | inf | bitflip | scale).
Plans are frozen dataclasses, so a fault is a value — tests construct
it, thread it through `lower()` / `compile_cached` /
`LoopProgram(fault=...)`, and the lowering wraps the matching
program's callable: fully deterministic and replayable. The wrapper is
plain torch arithmetic around the program's kernels, on the device the
program runs on, and a corrupted output is a new tensor (the loop
driver writes its stacks in place, so the program's own output buffer
is never written).

`bitflip` flips the second-highest exponent bit (0x40000000) of one
element chosen by `seed`, in float32 (a narrower float or an integer
output is widened to float32, flipped and cast back) — for values in
[1, 2) that manufactures an Inf/NaN, elsewhere a wildly mis-scaled
value, which is exactly the "single upset, huge blast radius" failure
the guards must catch. `scale` multiplies by `factor` (use factor=0.0
to provoke breakdown sentinels). On an integer output (iamax's index)
every kind gives what the reference package gives: nan 0, inf the
dtype's largest value, scale the factor truncated to the dtype first
(OverflowError if it does not fit), and the flipped float cast back
with saturation (NaN to 0).

Iteration gating reads the loop counter, which the driver publishes via
`loop_iteration(k)` around each guarded body; the wrapper compares
`current_iteration()` with `plan.iteration` on the host (the port's
loop counter is a host int, so the gate reads nothing from the
device). Outside any loop (setup stages, standalone dataflow programs)
an iteration-targeted fault stays dormant; `iteration=None` fires
everywhere.

The filesystem helpers (`truncate_file`, `corrupt_json`,
`torn_write`) are the chaos side of cache/checkpoint robustness: they
manufacture the on-disk states — truncated JSON, byte-corrupted JSON,
a write that died halfway — that `tune.store` quarantine and
checkpoint recovery tests must survive.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
from typing import Optional

FAULT_KINDS = ("nan", "inf", "bitflip", "scale")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault against a compiled program's outputs."""
    program: str                     # stage program name, "*" = any
    kind: str                        # nan | inf | bitflip | scale
    output: Optional[str] = None     # output name, None = all outputs
    iteration: Optional[int] = None  # outer-loop iteration, None = always
    factor: float = 1e20             # scale kind multiplier
    seed: int = 0                    # bitflip element choice

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if not isinstance(self.program, str) or not self.program:
            raise ValueError("FaultPlan.program must name a stage "
                             "program (or '*')")

    def matches(self, program_name) -> bool:
        """True if the plan targets `program_name`. Loop drivers name
        their stage programs `<loop>_<stage>`, so a plan targeting a
        loop name hits every stage program of that loop."""
        if self.program == "*":
            return True
        if not program_name:
            return False
        name = str(program_name)
        return name == self.program or name.startswith(
            self.program + "_")

    def key(self) -> tuple:
        """Content key, used to keep faulted compiles out of the clean
        program cache."""
        return (self.program, self.kind, self.output, self.iteration,
                self.factor, self.seed)


# -- loop-iteration context (driver publishes the traced counter) -----------

_ITER_STACK: list = []


@contextlib.contextmanager
def loop_iteration(k):
    """Driver-side: publish the loop counter (a host int) around the
    staged body so iteration-targeted faults can gate on it. Pure
    Python bookkeeping."""
    _ITER_STACK.append(k)
    try:
        yield
    finally:
        _ITER_STACK.pop()


def current_iteration():
    """The enclosing loop's iteration counter, or None outside any
    driver body."""
    return _ITER_STACK[-1] if _ITER_STACK else None


# -- value corruption -------------------------------------------------------


def _to_int(f, dtype):
    """A float tensor cast to an integer dtype of at most 32 bits (the
    programs' only integer output is iamax's int32 index) as the
    reference's cast does: toward zero, saturating at the dtype's range,
    NaN to 0. Every such bound is exact in float64."""
    import torch

    info = torch.iinfo(dtype)
    return torch.nan_to_num(f.double(), nan=0.0).clamp(
        info.min, info.max).to(dtype)


def _corrupted(value, plan: FaultPlan):
    import torch

    v = torch.as_tensor(value)
    is_int = not (v.is_floating_point() or v.is_complex())
    if plan.kind == "nan":
        return torch.zeros_like(v) if is_int else \
            torch.full_like(v, float("nan"))
    if plan.kind == "inf":
        return torch.full_like(v, torch.iinfo(v.dtype).max) if is_int \
            else torch.full_like(v, float("inf"))
    if plan.kind == "scale":
        if is_int:
            factor = int(plan.factor)
            info = torch.iinfo(v.dtype)
            if not info.min <= factor <= info.max:
                raise OverflowError(
                    f"Python integer {factor} out of bounds for {v.dtype}")
            return v * factor
        # the factor rounded to the output's dtype first, as the
        # reference does
        factor = torch.tensor(plan.factor, dtype=v.dtype).item()
        return v * factor
    # bitflip: one element, exponent bit 0x40000000, in float32 space
    flat = v.reshape(-1).to(torch.float32, copy=True)
    if flat.numel():
        bits = flat.view(torch.int32)
        idx = plan.seed % flat.numel()
        bits[idx] = bits[idx] ^ 0x40000000
    out = flat.reshape(v.shape)
    return _to_int(out, v.dtype) if is_int else out.to(v.dtype)


def corrupt(value, plan: FaultPlan):
    """Apply the plan to one value, gated on the published loop
    counter when the plan targets an iteration."""
    if plan.iteration is not None and \
            current_iteration() != plan.iteration:
        return value        # another iteration, or outside a loop
    return _corrupted(value, plan)


def wrap_program_fn(fn, plan: FaultPlan):
    """Wrap an emitted program callable (inputs dict -> outputs dict)
    so the plan's target outputs come back corrupted, as new tensors on
    the program's device."""
    def faulted(ins):
        out = dict(fn(ins))
        for name in out:
            if plan.output is None or name == plan.output:
                out[name] = corrupt(out[name], plan)
        return out
    # the loop driver keeps a lowering with a fault plan off its CUDA
    # graph path (`solvers.driver.graph_engages`)
    faulted.fault = plan
    return faulted


# -- filesystem chaos -------------------------------------------------------


class ChaosWriteError(OSError):
    """Raised by `torn_write` at the configured failure point."""


def truncate_file(path, *, keep: Optional[int] = None,
                  fraction: float = 0.5) -> int:
    """Truncate a file to `keep` bytes (or `fraction` of its size);
    returns the new size. A truncated JSON document is the classic
    crashed-mid-write artifact."""
    path = pathlib.Path(path)
    size = path.stat().st_size
    new = keep if keep is not None else int(size * fraction)
    new = max(0, min(new, size))
    with open(path, "rb+") as f:
        f.truncate(new)
    return new


def corrupt_json(path, *, seed: int = 0) -> None:
    """Deterministically corrupt a JSON file so it no longer parses:
    overwrite a seeded byte offset with garbage and knock out the
    closing brace."""
    path = pathlib.Path(path)
    data = bytearray(path.read_bytes())
    if not data:
        data = bytearray(b"\xff")
    else:
        data[seed % len(data)] = 0xFF
        data[-1] = ord("!")
    path.write_bytes(bytes(data))
    # sanity: the helper's contract is "no longer valid JSON"
    try:
        json.loads(bytes(data).decode("utf-8", errors="replace"))
    except (json.JSONDecodeError, ValueError):
        return
    path.write_bytes(b"{corrupt!")


def torn_write(path, text: str, *, fail_after: int) -> None:
    """Simulate a write interrupted after `fail_after` bytes: the
    partial content IS on disk (flushed), then ChaosWriteError raises
    as the crash. Exercises recovery paths that must not trust a
    non-atomically-written file."""
    path = pathlib.Path(path)
    data = text.encode("utf-8")
    with open(path, "wb") as f:
        f.write(data[:fail_after])
        f.flush()
        os.fsync(f.fileno())
    raise ChaosWriteError(
        f"torn write: {path} died after {fail_after} of "
        f"{len(data)} bytes")
