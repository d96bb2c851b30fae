"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

`execute` takes the device it is given; the command (`run.py`) gives it
the card and refuses to run without one. Tests give it the CPU and a
configuration cut to a tiny size, to drive the rest of a run.
"""
from __future__ import annotations

import dataclasses
import gc
import pathlib
import sys
import time
from typing import Dict, List, Optional

import torch

from . import manifest as mf
from . import tracing, work

# top-level modules that may not be loaded in the process that prints
# the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Window:
    """What the driver saw in one window: its length, the calls it
    completed, the calls that failed, and the answers kept for the
    check."""
    elapsed_s: float = 0.0
    calls: int = 0
    failed: int = 0
    answers: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    manifest: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    system: object = None
    driver: object = None
    inputs: Dict[str, object] = dataclasses.field(default_factory=dict)
    state: Dict[str, object] = dataclasses.field(default_factory=dict)
    windows: Dict[str, Window] = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None
    probe_s: List[float] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    kind: str = "cpu"
    root: pathlib.Path = mf.ROOT

    @property
    def peak(self) -> Optional[dict]:
        return work.PEAKS.get(self.kind)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare(cell_name: str, seed: int, seconds: float, trace: bool,
            device, *, root: pathlib.Path = mf.ROOT,
            config_overrides: Optional[dict] = None,
            traffic_overrides: Optional[dict] = None) -> Run:
    manifest = mf.load(root)
    cell = mf.cell(manifest, cell_name)
    cfg = mf.config(manifest, cell["config"], root)
    cfg.update(config_overrides or {})
    traffic = mf.traffic(cell["traffic"], root / "portbench")
    traffic.update(traffic_overrides or {})
    run = Run(manifest=manifest, cell=cell, config=cfg, traffic=traffic,
              seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), root=root)
    run.system = mf.module("systems", cfg["system"], root / "portbench")
    run.driver = mf.module("drivers", traffic["driver"], root / "portbench")
    if run.device.type == "cuda":
        run.kind = torch.cuda.get_device_name(run.device)
    return run


def execute(run: Run, t_start: float) -> dict:
    """Set up, measure, trace, check; returns the result line as a dict
    (its `checks` last)."""
    run.system.build(run)
    run.driver.warm(run)
    sync(run.device)
    run.setup_s = time.perf_counter() - t_start
    run.windows["timed"] = run.driver.window(run, run.seconds)
    if run.trace:
        probe = getattr(run.driver, "probe", None)
        if probe is not None:
            run.probe_s = probe(run)
        run.windows["traced"], run.trace_summary = traced_window(run)
    peak_bytes = 0
    if run.device.type == "cuda":       # the process's peak, set-up's too
        peak_bytes = torch.cuda.max_memory_allocated(run.device)
    run.state.clear()                # the program's handles, for the check
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = run.system.check(run)
    return result_line(run, checks, peak_bytes)


def traced_window(run: Run):
    """The driver's window under `torch.profiler`. On the card only CUDA
    activity is traced (kernels, copies and the runtime calls that
    issue them), not every host operation, so the profiler hardly slows
    the host and the trace's idle share is the program's own."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if run.device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        win = run.driver.window(run, run.seconds)
    return win, tracing.summarize(tracing.events_of(prof))


def result_line(run: Run, checks: list, peak_bytes: int) -> dict:
    wins = list(run.windows.values())
    metrics = {}
    for m in mf.metrics_of(run.manifest, run.cell["name"], run.trace):
        reader = mf.module("metrics", m["name"], run.root / "portbench")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.kind, "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(peak_bytes)}
    failed = sum(w.failed for w in wins)
    # a call that raised gave no answer; a NaN reading is no pass
    line = {"correct": bool(checks) and failed == 0
            and all(v <= lim for _, v, lim in checks),
            "attempted": sum(w.calls for w in wins),
            "failed": failed,
            "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        line["breakdown"] = {k: run.trace_summary[k]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line
