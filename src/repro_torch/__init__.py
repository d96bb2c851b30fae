"""PyTorch/CUDA port of the AIEBLAS-style BLAS library, for NVIDIA Hopper.

JSON routine spec -> dataflow graph -> fusion plan -> generated Triton
kernels (dataflow mode) / one kernel per routine (nodataflow) / torch
oracles (reference). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

This package imports ``torch`` only. ``triton`` is imported inside the
functions that launch a kernel, so every module imports on a host
without a card.
"""
from . import core, kernels  # noqa: F401
from .core import (AXPY_SPEC, AXPYDOT_SPEC, GEMV_SPEC, Program,  # noqa: F401
                   Results, axpy_program, axpydot_program, gemv_program)
