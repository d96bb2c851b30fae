"""The autouse fixture of the port's test files that record with
`repro_torch.obs` or `repro.obs`: each test runs against fresh, disabled
registries of both packages, and the registries (and export paths) that
were there before are put back afterwards.

Both registries are process-global and the port's tests share xdist
workers with the JAX tests, so a test that turns recording on must
never leave records, counters or an enabled registry behind: the
reference's `tests/test_obs.py` checks that its registry is empty and
disabled by default. A file imports the fixture by name, which makes it
autouse there; it stays out of `conftest.py`, where it would wrap every
JAX test too.
"""
import pytest

from repro.obs import core as jobs_core
from repro_torch.obs import core as obs_core


@pytest.fixture(autouse=True)
def isolated_obs_registries():
    saved = [(core, core._REGISTRY, core._EXPORT_PATH)
             for core in (jobs_core, obs_core)]
    for core, _, _ in saved:
        core._REGISTRY = core.Registry()
        core._EXPORT_PATH = None
    yield
    for core, registry, path in saved:
        core._REGISTRY = registry
        core._EXPORT_PATH = path
