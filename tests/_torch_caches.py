"""The autouse fixture of the port's test files that run the reference's
`Program` or `LoopProgram`: each test starts with both packages' lowering
caches empty and leaves them empty.

The reference keeps compiled programs in a process-wide cache, so a
program cached by a port test would let a JAX test that runs later in
the same worker skip the trace it counts. A file imports the fixture by
name, which makes it autouse there; it stays out of `conftest.py`, where
it would wrap every JAX test too.
"""
import pytest

from repro.core import lowering as jlowering
from repro_torch.core import lowering


@pytest.fixture(autouse=True)
def fresh_lowering_caches():
    lowering.clear_cache()
    yield
    jlowering.clear_cache()
    lowering.clear_cache()
