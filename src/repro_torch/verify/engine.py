"""Analyzer driver: raw spec in, `Report` out, before anything is
compiled, built or launched.

`analyze` never raises on spec problems — every finding lands in the
report. `check` is the raising wrapper `lower(..., verify=True)` uses:
errors become one `VerifyError` carrying the whole report.

The heavy lifting is deliberately NOT re-implemented here. The same
validation code lowering runs in raise mode is re-run with a
`DiagnosticSink`, which flips every `spec_error` site in
`core.spec`/`core.graph`/`core.lowering` into record-and-continue, and
makes stage programs probe-lower (parse -> graph -> infer, no codegen,
no kernel built).
That guarantees the analyzer and the compiler can never disagree about
what is legal, and keeps messages byte-identical across both paths.
The lint passes in `verify.passes` then add the findings only whole-
program analysis can see.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch import obs
from repro_torch.core import graph as graph_mod, lowering
from repro_torch.core import spec as spec_mod

from . import passes
from .diagnostics import DiagnosticSink, Report, VerifyError


def _spec_name(raw: Mapping) -> Optional[str]:
    name = raw.get("name")
    return name if isinstance(name, str) else None


def analyze(raw, *, mode: str = "dataflow") -> Report:
    """Statically verify a raw spec (dict, JSON string, or path).
    Returns a `Report`; never raises on spec problems."""
    raw = lowering._canonical_raw(raw)
    sink = DiagnosticSink()
    with obs.span("verify.analyze", mode=mode):
        if spec_mod.is_loop_spec(raw):
            kind = "loop"
            name = _spec_name(raw)
            lspec = None
            try:
                lspec = spec_mod.parse_loop(raw)
            except spec_mod.SpecError as e:
                sink.error_from(e)
            if lspec is not None:
                name = lspec.name
                lir = None
                try:
                    lir = lowering.lower_loop(
                        lspec, mode=mode, tiles="default", sink=sink,
                        verify=False)
                except spec_mod.SpecError as e:   # pragma: no cover
                    sink.error_from(e)            # sink mode records,
                passes.run_loop_passes(lspec, lir, sink)
        else:
            kind = "dataflow"
            name = _spec_name(raw)
            spec = None
            try:
                spec = spec_mod.parse(raw)
            except spec_mod.SpecError as e:
                sink.error_from(e)
            if spec is not None:
                name = spec.name
                g = graph_mod.DataflowGraph(spec, validate=False,
                                            sink=sink)
                graph_mod.check_port_kinds(g, sink)
                g.order = graph_mod.topo_sort(g, sink)
                if len(g.order) == len(g.nodes):
                    io = graph_mod.collect_io(g, sink)
                    g.inputs, g.outputs = io.inputs, io.outputs
                else:
                    g.order = None   # cycle: leave order unset
                passes.run_dataflow_passes(spec, g, sink, mode=mode)

    report = sink.report(program=name, kind=kind)
    if obs.enabled():
        for d in report.diagnostics:
            obs.counter(f"verify.{d.severity}", code=d.code)
        obs.event("verify.done", program=name, kind=kind,
                  errors=len(report.errors),
                  warnings=len(report.warnings),
                  infos=len(report.infos))
    return report


def check(raw, *, mode: str = "dataflow") -> Report:
    """Verify a raw spec, raising `VerifyError` (a `SpecError`) with
    the full report when any error-severity diagnostic fires."""
    report = analyze(raw, mode=mode)
    if not report.ok:
        raise VerifyError(report)
    return report
