def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips on a host without one (run on the "
        "card with `python -m pytest -m cuda tests/test_torch_*.py`)")
