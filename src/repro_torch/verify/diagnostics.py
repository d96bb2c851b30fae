"""Typed diagnostics for the spec static analyzer.

Every finding is a `Diagnostic`: a stable code (``RVnnn``), a severity,
the human message, a JSON path into the offending spec, and an optional
one-line fix-it hint. A verification run collects them into a `Report`;
`VerifyError` is the single exception `lower(..., verify=True)` raises
when a report contains errors, carrying the full report so callers see
every problem at once instead of fix-one-rerun loops.

`DiagnosticSink` is the collection half: `core.spec.spec_error` and the
sink-threaded validation passes in `core.graph` / `core.lowering` call
``sink.error(message, code=..., path=..., hint=...)`` on it instead of
raising, so the analyzer reuses the exact raise sites (and message
strings) the normal lowering path enforces with.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Tuple

from repro_torch.core.spec import SpecError

SEVERITIES = ("error", "warning", "info")

# code -> short title: the stable catalog, the reference package's codes
CATALOG = {
    "RV100": "malformed spec",
    "RV101": "unknown routine",
    "RV102": "duplicate routine name",
    "RV103": "unknown port or scalar",
    "RV104": "bad connection target",
    "RV105": "edge type mismatch",
    "RV106": "input port driven twice",
    "RV107": "dataflow cycle",
    "RV108": "conflicting input kinds",
    "RV109": "bad program outputs",
    "RV110": "reduced-precision accumulation",
    "RV111": "unsupported dtype",
    "RV112": "bad vector width",
    "RV201": "undefined name",
    "RV202": "rebind or shadow",
    "RV203": "dead binding",
    "RV204": "feedback never updated",
    "RV205": "constant cond predicate",
    "RV206": "stack index out of bounds",
    "RV207": "reserved name",
    "RV208": "kind mismatch",
    "RV209": "bad stop rule",
    "RV210": "misplaced stage",
    "RV211": "bad loop structure",
    "RV301": "division by zero",
    "RV302": "sqrt of negative",
    "RV303": "guarded division",
    "RV401": "shared-memory budget exceeded",
    "RV402": "window not vector-width aligned",
    "RV403": "duplicate slot store",
    "RV500": "malformed guards section",
    "RV501": "unknown guard target",
    "RV502": "breakdown guard target not scalar or vector",
    "RV503": "guard parameter out of range",
    "RV504": "matrix state shape mismatch",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str           # "error" | "warning" | "info"
    message: str
    path: Optional[str] = None   # JSON path into the spec
    hint: Optional[str] = None   # one-line fix-it

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message}
        if self.path is not None:
            d["path"] = self.path
        if self.hint is not None:
            d["hint"] = self.hint
        return d

    def format(self) -> str:
        loc = f" at {self.path}" if self.path else ""
        msg = self.message
        # raise-site messages already lead with the spec path; don't
        # print it twice
        if self.path and msg.startswith(f"{self.path}: "):
            msg = msg[len(self.path) + 2:]
        out = f"{self.severity} {self.code}{loc}: {msg}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass(frozen=True)
class Report:
    """All diagnostics from one verification run of one spec."""
    program: Optional[str]
    kind: str                          # "loop" | "dataflow"
    diagnostics: Tuple[Diagnostic, ...]

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == "warning")

    @property
    def infos(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == "info")

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: str) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.code == code)

    def to_dict(self) -> dict:
        return {"program": self.program, "kind": self.kind,
                "ok": self.ok,
                "counts": {"error": len(self.errors),
                           "warning": len(self.warnings),
                           "info": len(self.infos)},
                "diagnostics": [d.to_dict() for d in self.diagnostics]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def format(self) -> str:
        name = self.program or "<spec>"
        lines = [d.format() for d in self.diagnostics]
        summary = (f"{name}: {len(self.errors)} error(s), "
                   f"{len(self.warnings)} warning(s), "
                   f"{len(self.infos)} info(s)")
        return "\n".join(lines + [summary])


class VerifyError(SpecError):
    """Raised by `verify.check` / `lower(..., verify=True)` when the
    analyzer finds errors. Subclasses `SpecError` and reproduces every
    error message verbatim in `str(exc)`, so handlers (and tests) that
    match on lowering's message strings keep working unchanged; the
    structured findings ride along as `.report`."""

    def __init__(self, report: Report):
        errors = report.errors
        name = report.program or "<spec>"
        first = errors[0] if errors else None
        lines = [f"spec {name!r} failed verification with "
                 f"{len(errors)} error(s):"]
        lines += [e.message for e in errors]
        super().__init__(
            "\n".join(lines),
            code=first.code if first else None,
            path=first.path if first else None,
            hint=first.hint if first else None)
        self.report = report


# untagged raise sites already prefix messages with a spec path
# ("iterate.body[0].cond.if: ..."); recover it for the report
_PATH_PREFIX = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\[\]]*):\s")


class DiagnosticSink:
    """Collects diagnostics; duck-typed target of `spec_error(sink,...)`
    in `core.spec` and the sink-threaded passes in graph/lowering."""

    def __init__(self) -> None:
        self._diags: list = []

    def add(self, severity: str, message: str, *,
            code: Optional[str] = None, path: Optional[str] = None,
            hint: Optional[str] = None) -> None:
        if path is None:
            m = _PATH_PREFIX.match(message)
            if m:
                path = m.group(1)
        self._diags.append(Diagnostic(
            code=code or "RV100", severity=severity, message=message,
            path=path, hint=hint))

    def error(self, message: str, *, code=None, path=None,
              hint=None) -> None:
        self.add("error", message, code=code, path=path, hint=hint)

    def warn(self, message: str, *, code=None, path=None,
             hint=None) -> None:
        self.add("warning", message, code=code, path=path, hint=hint)

    def info(self, message: str, *, code=None, path=None,
             hint=None) -> None:
        self.add("info", message, code=code, path=path, hint=hint)

    def error_from(self, exc: SpecError) -> None:
        """Record a raised SpecError (parse failures happen before the
        sink-threaded passes get a chance to record-and-continue)."""
        self.error(str(exc),
                   code=getattr(exc, "code", None),
                   path=getattr(exc, "path", None),
                   hint=getattr(exc, "hint", None))

    def report(self, *, program: Optional[str],
               kind: str) -> Report:
        return Report(program=program, kind=kind,
                      diagnostics=tuple(self._diags))
