"""`repro_torch.verify` — whole-program static analyzer for BLAS specs,
the port's own copy of the reference package's (`repro.verify`).

Runs before anything is compiled and reports typed diagnostics (stable
``RVnnn`` codes, severity, JSON path into the spec, fix-it hint) over
both spec kinds: dataflow programs (graph structure, port typing,
dtype policy, each group's shared memory per thread block) and loop
programs (environment dataflow, stack bounds, expression numerics).

    from repro_torch import verify
    report = verify.analyze(spec)        # never raises
    verify.check(spec)                   # raises VerifyError on errors

Lowering calls `check` by default (`lower(..., verify=True)`), so a
malformed spec fails with every finding at once, before any kernel is
built; ``python -m repro_torch.verify`` is the CLI over the same
engine. The catalog (`diagnostics.CATALOG`) has the reference's codes;
RV401 prices shared memory (`passes`).
"""
from .diagnostics import (CATALOG, Diagnostic, DiagnosticSink, Report,
                          VerifyError)
from .engine import analyze, check

__all__ = [
    "CATALOG",
    "Diagnostic",
    "DiagnosticSink",
    "Report",
    "VerifyError",
    "analyze",
    "check",
]
