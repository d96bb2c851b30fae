"""PyTorch/CUDA port of the AIEBLAS-style BLAS library, for NVIDIA Hopper.

JSON routine spec -> dataflow graph -> fusion plan -> generated Triton
kernels (dataflow mode) / one kernel per routine (nodataflow) / torch
oracles (reference); JSON loop solvers and class-based solvers over such
programs; the public `blas` API (routine calls, the fluent builder,
`blas.compile` and the solver functions); robust solves (`guard`:
fault plans, the escalation ladder behind `blas.solve` and the chaos
drill); the `obs` spans, counters and events over the whole pipeline;
the tuning store's data layer (`tune`) and the straggler watchdog
(`ft`); and the LM
serve path (configs, models, serve), whose prefill and decode attention
run the port's flash-attention and decode-attention kernels. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version
instead.

This package imports ``torch`` only. ``triton`` is imported inside the
functions that launch a kernel, so every module imports on a host
without a card.
"""
from . import (blas, configs, core, ft, guard, kernels,  # noqa: F401
               models, obs, serve, solvers, tune)
from .core import (AXPY_SPEC, AXPYDOT_SPEC, GEMV_SPEC, Program,  # noqa: F401
                   Results, axpy_program, axpydot_program, gemv_program)
