"""The autouse fixture of the port's test files that run the reference's
`Program`, `LoopProgram`, class solvers or `blas` API: each test starts
with both packages' lowering caches and the port's `blas` memos empty,
and leaves them, and the reference's solver-executable memo
(`repro.blas.solvers._EXECUTABLES`), empty.

The reference keeps compiled programs in a process-wide cache, and its
`blas` solver functions keep their executables in a memo, so a program
cached by a port test would let a JAX test that runs later in the same
worker skip the trace it counts. The port's own memos (the routine
functions' compiled programs and `repro_torch.blas.solvers`'
executables) would outlive a cleared port cache in the same way. A file
imports the fixture by name, which makes it autouse there; it stays out
of `conftest.py`, where it would wrap every JAX test too.
"""
import pytest

from repro.blas import solvers as jblas_solvers
from repro.core import lowering as jlowering
from repro_torch import blas
from repro_torch.blas import solvers as blas_solvers
from repro_torch.core import lowering


def _clear_port():
    lowering.clear_cache()
    blas_solvers._EXECUTABLES.clear()
    for name in blas.routines():
        getattr(blas, name)._compiled.clear()


@pytest.fixture(autouse=True)
def fresh_lowering_caches():
    _clear_port()
    yield
    jlowering.clear_cache()
    jblas_solvers._EXECUTABLES.clear()
    _clear_port()
