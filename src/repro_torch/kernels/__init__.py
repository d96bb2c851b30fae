"""Hand-written Hopper kernels (Triton for level 1 and the generated
groups, CUDA C++ for the level-2 matvecs and gemm) with their plain
PyTorch versions.

Every public wrapper launches its kernel on a CUDA tensor and runs its
plain version on a CPU tensor; each keeps integer `launches` and
`plain_calls` counters (see `common.counted`).
"""
from . import (anchored, axpy, axpydot, common, cuda, dot,  # noqa: F401
               gemm, gemv, ops, ref, symv, tiled, window)
