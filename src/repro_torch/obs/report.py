"""Aggregation over obs records: summaries for the CLI and the
modeled-vs-measured drift report (`DriftReport`, the shape that
`Executable.profile` returns once the port has it).

Everything here operates on plain record dicts (the JSONL schema in
`obs.core`) or plain numbers — no torch, no repro_torch.core imports —
so the CLI can digest files from any process.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, List, Mapping, Optional, Tuple


# ---------------------------------------------------------------------------
# Record aggregation (CLI: summarize / diff)
# ---------------------------------------------------------------------------


def load_jsonl(path) -> List[dict]:
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def summarize_records(records: Iterable[dict]) -> dict:
    """Aggregate a record stream:

    spans    -> name: {count, total_s, mean_s, max_s}
    counters -> name: total n
    events   -> name: count
    """
    spans: dict = {}
    counters: dict = {}
    events: dict = {}
    for r in records:
        kind = r.get("kind")
        name = r.get("name", "?")
        if kind == "span":
            s = spans.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += float(r.get("dur_s", 0.0))
            s["max_s"] = max(s["max_s"], float(r.get("dur_s", 0.0)))
        elif kind == "counter":
            counters[name] = counters.get(name, 0) + int(r.get("n", 1))
        elif kind == "event":
            events[name] = events.get(name, 0) + 1
    for s in spans.values():
        s["mean_s"] = s["total_s"] / s["count"]
    return {"spans": spans, "counters": counters, "events": events}


def format_summary(summary: Mapping) -> str:
    lines = []
    if summary["spans"]:
        lines.append("spans:")
        lines.append(f"  {'name':<32} {'count':>7} {'total_ms':>10} "
                     f"{'mean_ms':>10} {'max_ms':>10}")
        for name in sorted(summary["spans"],
                           key=lambda n: -summary["spans"][n]["total_s"]):
            s = summary["spans"][name]
            lines.append(
                f"  {name:<32} {s['count']:>7} "
                f"{1e3 * s['total_s']:>10.3f} "
                f"{1e3 * s['mean_s']:>10.3f} "
                f"{1e3 * s['max_s']:>10.3f}")
    if summary["counters"]:
        lines.append("counters:")
        for name in sorted(summary["counters"]):
            lines.append(f"  {name:<40} {summary['counters'][name]:>10,}")
    if summary["events"]:
        lines.append("events:")
        for name in sorted(summary["events"]):
            lines.append(f"  {name:<40} {summary['events'][name]:>10,}")
    if not lines:
        lines.append("(no records)")
    return "\n".join(lines)


def diff_summaries(a: Mapping, b: Mapping) -> str:
    """Side-by-side comparison of two summaries (A -> B): span mean
    times with ratios, counter totals with deltas."""
    lines = []
    span_names = sorted(set(a["spans"]) | set(b["spans"]))
    if span_names:
        lines.append(f"{'span':<32} {'A_mean_ms':>10} {'B_mean_ms':>10} "
                     f"{'B/A':>8}")
        for name in span_names:
            sa = a["spans"].get(name)
            sb = b["spans"].get(name)
            ma = 1e3 * sa["mean_s"] if sa else float("nan")
            mb = 1e3 * sb["mean_s"] if sb else float("nan")
            if sa and sb and sa["mean_s"] > 0:
                ratio = f"{sb['mean_s'] / sa['mean_s']:>8.2f}"
            else:
                ratio = f"{'-':>8}"
            lines.append(f"{name:<32} {ma:>10.3f} {mb:>10.3f} {ratio}")
    ctr_names = sorted(set(a["counters"]) | set(b["counters"]))
    if ctr_names:
        lines.append(f"{'counter':<32} {'A':>10} {'B':>10} {'delta':>8}")
        for name in ctr_names:
            ca = a["counters"].get(name, 0)
            cb = b["counters"].get(name, 0)
            lines.append(f"{name:<32} {ca:>10,} {cb:>10,} {cb - ca:>+8,}")
    if not lines:
        lines.append("(nothing to compare)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Drift report: modeled bytes/roofline time vs measured wall clock
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftRow:
    """One fused-group (or standalone-kernel) line of a drift report.

    `modeled_time_s` is the roofline lower bound max(flops/peak,
    bytes/bw); `measured_s` the mean wall clock of one execution of the
    group's generated kernel(s); `drift` their ratio — 1.0 means the
    cost model predicts reality, larger means the kernel runs slower
    than modeled."""
    label: str                  # program.g<idx>
    program: str
    group: int
    routines: Tuple[str, ...]
    anchor: Optional[str]
    calls: int                  # executions per profiled run/iteration
    modeled_flops: int
    modeled_bytes: int
    modeled_time_s: float
    measured_s: Optional[float]     # None: group never ran concretely

    @property
    def drift(self) -> Optional[float]:
        if self.measured_s is None or not self.modeled_time_s:
            return None
        return self.measured_s / self.modeled_time_s


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Modeled-vs-measured join for one executable under profiling.

    For loop programs the rows cover the top-level body stages; kernel
    spans of stages with no model row (inside `cond` branches and
    nested loops) show up in `unmatched`."""
    program: str
    mode: str
    kind: str                       # "dataflow" | "loop"
    iters: int                      # profiled runs / body iterations
    rows: Tuple[DriftRow, ...]
    unmatched: Tuple[dict, ...] = ()   # measured spans with no model row

    @property
    def modeled_bytes(self) -> int:
        return sum(r.modeled_bytes * r.calls for r in self.rows)

    @property
    def modeled_time_s(self) -> float:
        return sum(r.modeled_time_s * r.calls for r in self.rows)

    @property
    def measured_s(self) -> float:
        return sum((r.measured_s or 0.0) * r.calls for r in self.rows)

    @property
    def drift(self) -> Optional[float]:
        if not self.modeled_time_s:
            return None
        return self.measured_s / self.modeled_time_s

    def to_json(self) -> dict:
        return {
            "program": self.program, "mode": self.mode,
            "kind": self.kind, "iters": self.iters,
            "modeled_bytes": self.modeled_bytes,
            "modeled_time_us": 1e6 * self.modeled_time_s,
            "measured_us": 1e6 * self.measured_s,
            "drift": self.drift,
            "groups": [{
                "label": r.label, "routines": list(r.routines),
                "anchor": r.anchor, "calls": r.calls,
                "modeled_flops": r.modeled_flops,
                "modeled_bytes": r.modeled_bytes,
                "modeled_time_us": 1e6 * r.modeled_time_s,
                "measured_us": (None if r.measured_s is None
                                else 1e6 * r.measured_s),
                "drift": r.drift,
            } for r in self.rows],
        }

    def __str__(self):
        unit = "iteration" if self.kind == "loop" else "call"
        lines = [f"drift report: {self.program!r} mode={self.mode} "
                 f"(per {unit}, measured over {self.iters} "
                 f"instrumented {unit}s)"]
        lines.append(f"  {'group':<34} {'modeled_B':>11} "
                     f"{'modeled_us':>11} {'measured_us':>12} "
                     f"{'drift':>9}")
        for r in self.rows:
            meas = ("-" if r.measured_s is None
                    else f"{1e6 * r.measured_s:.1f}")
            drift = "-" if r.drift is None else f"{r.drift:.1f}x"
            label = r.label if len(r.label) <= 34 else r.label[:31] + "..."
            lines.append(
                f"  {label:<34} {r.modeled_bytes:>11,} "
                f"{1e6 * r.modeled_time_s:>11.3f} {meas:>12} "
                f"{drift:>9}")
        drift = "-" if self.drift is None else f"{self.drift:.1f}x"
        lines.append(
            f"  total: {self.modeled_bytes:,} B modeled, "
            f"{1e6 * self.modeled_time_s:.3f} us roofline vs "
            f"{1e6 * self.measured_s:.3f} us measured -> drift {drift}")
        for u in self.unmatched:
            lines.append(f"  (unmatched measurement: {u['label']} "
                         f"{1e6 * u['measured_s']:.1f} us x{u['calls']})")
        return "\n".join(lines)


def join_drift(program: str, mode: str, kind: str, iters: int,
               model_rows: List[dict], span_records: Iterable[dict]
               ) -> DriftReport:
    """Join modeled per-group cost rows against measured kernel spans.

    `model_rows` entries carry program/group/routines/anchor/flops/
    bytes/time_s/calls; spans are matched on the (program, group)
    attrs that `core.codegen` stamps on every kernel.group span."""
    agg: dict = {}
    for r in span_records:
        if r.get("kind") != "span" or r.get("name") != "kernel.group":
            continue
        attrs = r.get("attrs", {})
        key = (attrs.get("program"), attrs.get("group"))
        a = agg.setdefault(key, {"count": 0, "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += float(r.get("dur_s", 0.0))

    rows, matched = [], set()
    for m in model_rows:
        key = (m["program"], m["group"])
        matched.add(key)
        meas = agg.get(key)
        measured_s = (meas["total_s"] / meas["count"]) if meas else None
        rows.append(DriftRow(
            label=f"{m['program']}.g{m['group']}",
            program=m["program"], group=m["group"],
            routines=tuple(m["routines"]), anchor=m.get("anchor"),
            calls=m.get("calls", 1), modeled_flops=m["flops"],
            modeled_bytes=m["bytes"], modeled_time_s=m["time_s"],
            measured_s=measured_s))
    unmatched = tuple(
        {"label": f"{k[0]}.g{k[1]}", "calls": a["count"],
         "measured_s": a["total_s"] / a["count"]}
        for k, a in sorted(agg.items(), key=lambda kv: str(kv[0]))
        if k not in matched)
    return DriftReport(program=program, mode=mode, kind=kind,
                       iters=iters, rows=tuple(rows),
                       unmatched=unmatched)
