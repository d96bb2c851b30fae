"""Solver status codes.

A pure-constants module, the same codes as the reference package's
status module. The codes are int8: the loop driver keeps the status of
a solve as one int8 tensor on the device, and the host reads that one
byte per iteration to decide whether to go on. RUNNING is internal to
the driver (a solve still iterating) and never appears in a returned
`SolverResult`.
"""
from __future__ import annotations

RUNNING = -1     # internal: still iterating
CONVERGED = 0    # metric <= rtol * scale
MAX_ITERS = 1    # iteration budget exhausted, no other diagnosis
BREAKDOWN = 2    # a breakdown sentinel scalar collapsed (|v| < below)
NONFINITE = 3    # NaN/Inf in a guarded value or the stop metric
DIVERGED = 4     # metric exceeded factor * its initial value
STAGNATED = 5    # no metric improvement for `window` iterations

STATUS_NAMES = {
    RUNNING: "RUNNING",
    CONVERGED: "CONVERGED",
    MAX_ITERS: "MAX_ITERS",
    BREAKDOWN: "BREAKDOWN",
    NONFINITE: "NONFINITE",
    DIVERGED: "DIVERGED",
    STAGNATED: "STAGNATED",
}


def status_name(code) -> str:
    """Human name for a status code (accepts Python ints and 0-d
    tensors)."""
    return STATUS_NAMES.get(int(code), f"UNKNOWN({int(code)})")


def is_failure(code) -> bool:
    """True for any outcome other than CONVERGED."""
    return int(code) != CONVERGED
