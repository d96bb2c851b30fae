"""`repro_torch.blas` — the library's public front door.

Three tiers, lowest friction first:

1. **Routine calls** (SciPy-style, registry-generated): one function
   per `core.routines` entry —

       from repro_torch import blas
       beta = blas.dot(x, y)
       z = blas.axpy(0.5, x, y)

   Each is backed by a digest-cached single-routine spec: repeated
   calls compile once. `python -m repro_torch.blas --list` prints the
   table.

2. **ProgramBuilder** (fluent composition):

       b = blas.program("axpydot")
       z = b.axpy(alpha=b.input("neg_alpha"), x="v", y="w")
       b.dot(x=z, y="u", out="beta")
       exe = blas.compile(b)
       beta = exe.one(neg_alpha=-0.7, v=v, w=w, u=u)

   Builders round-trip losslessly to/from the raw JSON spec
   (`ProgramBuilder.from_spec(x).to_spec()` is digest-identical to x)
   and cover loop programs via `b.operand(...)` / `b.iterate(...)`.

3. **Raw JSON specs** — the AIEBLAS-style dicts everything lowers
   from remain first-class: `blas.compile(spec_dict)` accepts them
   directly, as do `core.Program` and `solvers.LoopProgram`.

`blas.compile(...)` returns an `Executable` whatever the input kind:
`.run() / .one() / .batched() / .describe() / .cost_report() /
.save()`, with `blas.load(path)` compiling a saved spec back. The
solver convenience functions (`cg`, `block_cg`, `bicgstab`, `gmres`,
`jacobi`, `power_iteration`, and `pcg` with a `pivoted_cholesky`
preconditioner) run on the same path, and `blas.solve` runs them under
the escalation ladder (`EscalationPolicy`, `RecoveryError`; PCG first
when given `precond=`). `__all__` is the reference package's API: `pcg`,
`pivoted_cholesky` and `PivotedCholesky`, which it lacks, are attributes
of this module outside it. Everything runs on the CUDA card unless given
`device="cpu"`.
"""
from __future__ import annotations

from repro_torch.guard.escalate import (EscalationPolicy,  # noqa: F401
                                        RecoveryError)

from . import functional as _functional
from .builder import (BuilderError, InputRef, Port,  # noqa: F401
                      ProgramBuilder, StateRef, cond, inner_loop, let,
                      program, read, stage, store)
from .executable import (CostReport, Executable, compile,  # noqa: F401
                         load)
from .solvers import (PivotedCholesky, bicgstab,  # noqa: F401
                      block_cg, cg, gmres, jacobi, pcg, pivoted_cholesky,
                      power_iteration, solve)

__all__ = [
    "BuilderError", "CostReport", "EscalationPolicy", "Executable",
    "InputRef", "Port", "ProgramBuilder", "RecoveryError", "StateRef",
    "api_table", "bicgstab", "block_cg", "cg", "compile", "cond",
    "gmres", "inner_loop", "jacobi", "let", "load", "power_iteration",
    "program", "read", "routines", "solve", "stage", "store",
]

api_table = _functional.api_table


def routines() -> list:
    """Registry routine names — each is also a `blas.<name>` callable."""
    from repro_torch.core import routines as R
    return list(R.names())


# the registry-generated routine layer: one module attribute per routine
# (axpy, dot, gemv, gemm, ...). New registry entries appear here — and
# in __all__ — for free.
_ROUTINE_FNS = _functional.build_namespace()
globals().update(_ROUTINE_FNS)
__all__ += sorted(_ROUTINE_FNS)
del _functional
