"""Solver status codes of the port's loop driver (`solvers/driver.py`).

The port's own copy of the reference's code space: the fault-injection
harness and the escalation ladder that share it there are ROADMAP
Queue 1, item 10.
"""
from .status import (  # noqa: F401
    BREAKDOWN, CONVERGED, DIVERGED, MAX_ITERS, NONFINITE, RUNNING,
    STAGNATED, STATUS_NAMES, is_failure, status_name,
)

__all__ = [
    "RUNNING", "CONVERGED", "MAX_ITERS", "BREAKDOWN", "NONFINITE",
    "DIVERGED", "STAGNATED", "STATUS_NAMES", "status_name",
    "is_failure",
]
