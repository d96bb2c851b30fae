import pytest


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A tuning store of the test's own: `blas.compile` writes there."""
    from repro_torch.tune import store as tune_store

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    tune_store.reset_store()
    yield
    tune_store.reset_store()
