"""repro_torch.guard — in-loop failure detection, deterministic fault
injection, and graceful solver degradation, the reference package's
`guard` layer on the port.

Three layers, one package:

* `status` — the `SolverResult.status` int8 code space shared by the
  loop driver, the escalation driver, and the chaos harness
  (CONVERGED / MAX_ITERS / BREAKDOWN / NONFINITE / DIVERGED /
  STAGNATED).
* `chaos` — `FaultPlan`: deterministic, seeded fault injection into
  compiled dataflow programs (NaN / Inf / bitflip / scale at a chosen
  loop iteration), plus filesystem chaos helpers (truncation, JSON
  corruption, torn writes) for cache robustness tests.
* `escalate` — `EscalationPolicy` + the host-side retry driver behind
  `repro_torch.blas.solve`: reacts to failure status codes with an
  ordered fallback chain (retry-with-restart -> switch solver
  CG -> BiCGStab -> GMRES -> dense float64 on the operands' device),
  bounded attempts, obs telemetry on every attempt.

`python -m repro_torch.guard --chaos-smoke [--device cpu]` runs the
fault-injection matrix over all shipped loop specs and writes a JSON
fault report.
"""
from .status import (  # noqa: F401
    BREAKDOWN, CONVERGED, DIVERGED, MAX_ITERS, NONFINITE, RUNNING,
    STAGNATED, STATUS_NAMES, is_failure, status_name,
)
from .chaos import (  # noqa: F401
    ChaosWriteError, FaultPlan, corrupt_json, torn_write,
    truncate_file,
)
from .escalate import (  # noqa: F401
    Attempt, EscalationPolicy, RecoveryError, solve_with_policy,
)

__all__ = [
    "RUNNING", "CONVERGED", "MAX_ITERS", "BREAKDOWN", "NONFINITE",
    "DIVERGED", "STAGNATED", "STATUS_NAMES", "status_name",
    "is_failure",
    "FaultPlan", "ChaosWriteError", "truncate_file", "corrupt_json",
    "torn_write",
    "Attempt", "EscalationPolicy", "RecoveryError",
    "solve_with_policy",
]
