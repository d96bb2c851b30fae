"""Hand-written Hopper kernels (Triton for level 1 and the generated
groups, CUDA C++ for the level-2 matvecs, gemm, ger, transpose and the
two attention kernels) with their plain
PyTorch versions.

Every public wrapper launches its kernel on a CUDA tensor and runs its
plain version on a CPU tensor; each keeps integer `launches` and
`plain_calls` counters (see `common.counted`).
"""
from . import (anchored, attention, axpy, axpydot, common,  # noqa: F401
               cuda, decode_attention, dot, gemm, gemv, ger, ops, ref, symv,
               tiled, transpose, window)
