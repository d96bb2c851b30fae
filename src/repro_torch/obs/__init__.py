"""`repro_torch.obs` — observability for the port's compile/run pipeline.

Structured spans, counters and event records with a process-local
registry, zero overhead when disabled (the default), and JSONL export:
the reference package's `obs` layer, with its record names and
attributes, over a registry of the port's own. Instrumented sites:

* `core.lowering` — one span per compiler pass (parse -> graph ->
  infer -> fuse -> place -> emit), `lowering.done`, the
  `lowering.cache.hit/miss` counters of the digest-keyed program cache
  and `guard.fault.armed` when a fault plan wraps a program;
* `core.fusion` — one `fusion.absorb` / `fusion.reject` decision event
  per anchor candidate, with the planner's reason;
* `blas.executable` — a `program.call` span around each
  `Executable.run` of a dataflow program: the root of one call, whose
  id every span of the call reaches through its parents;
* `core.codegen` — one `codegen.group` event per generated kernel or
  standalone dispatch, and `kernel.group` spans around each group's
  launch, blocking on its outputs where the registry waits (never
  inside a CUDA-graph capture);
* `kernels.window` — a `window.launch` span around each window pass
  (buffers, grid, tickets, its one Triton launch), a `window.scalars`
  span around its scalar operands' packing, the `window.in_place`
  counter of the tensor scalars the kernel reads where they live and
  the `window.copies` counter of the copies a scalar block issues (0
  where there is none);
* `solvers.driver` — `solver.solve` spans, `loop.trace` (once per
  build of a solve), `loop.inner` spans around nested loops and the
  `solver.result` event (iterations, final residual, converged,
  status), which reads the device only while recording (`solver.solve`
  blocks on the solve where the registry waits); a `loop.iter` span per
  outer iteration holding the `loop.stop` span of its stop read, a
  `loop.stage` span per stage run (its `stage` attribute the stage
  program's name), and the `loop.iterations` counter, once a solve;
  on a loop's CUDA-graph path (a replayed iteration keeps its
  `loop.iter` and `loop.stop` spans and runs no stage span) the
  `loop.graph_captures` counter, once a capture, and
  `loop.graph_replays`, once a solve by its replays;
* `solvers.pcg` — a `precond.build` span around `pivoted_cholesky`;
* `guard.escalate` — a `guard.attempt` event and counters per rung of
  the escalation ladder.

Typical use:

    from repro_torch import blas, obs
    obs.enable()
    x = blas.cg(A, b)                 # instrumented end to end
    obs.export("solve.jsonl")         # python -m repro_torch.obs summarize ...

or `REPRO_TORCH_OBS_JSONL=trace.jsonl python my_script.py` with no code
changes. `with obs.capture(wait=False) as reg:` records without any
site waiting for the device, on the clock of `torch.profiler`'s events
(`start_ns`, `end_ns`), so a trace taken around it shows the program's
own pace with its spans on the same timeline. `DriftReport` and
`join_drift` are the data types of the modeled-vs-measured report that
`Executable.profile` builds.
"""
from .core import (NULL_SPAN, Registry, block, capture,  # noqa: F401
                   concrete, counter, counters, disable, enable,
                   enabled, event, export, get_registry, null_span,
                   records, reset, span, span_with, waiting)
from .report import (DriftReport, DriftRow, diff_summaries,  # noqa: F401
                     format_summary, join_drift, load_jsonl,
                     summarize_records)

__all__ = [
    "DriftReport", "DriftRow", "NULL_SPAN", "Registry", "block",
    "capture", "concrete", "counter", "counters", "diff_summaries",
    "disable", "enable", "enabled", "event", "export",
    "format_summary", "get_registry", "join_drift", "load_jsonl",
    "null_span", "records", "reset", "span", "span_with",
    "summarize_records", "waiting",
]
