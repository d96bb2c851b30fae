"""Hand-written Hopper kernels (Triton) with their plain PyTorch versions.

Every public wrapper launches its kernel on a CUDA tensor and runs its
plain version on a CPU tensor; each keeps integer `launches` and
`plain_calls` counters (see `common.counted`).
"""
from . import axpy, axpydot, common, dot, ops, ref, window  # noqa: F401
