"""`repro_torch.tune` — the port's tile configurations, its autotuner,
and its persistent tuning and compiled-artifact store
(`~/.cache/repro_torch`, or `REPRO_TORCH_CACHE_DIR`), apart from the
reference package's.

The config/store layer loads eagerly (core.lowering imports it to
resolve `tiles="auto"`); the autotuner itself, which pulls in the blas
runtime, loads lazily, keeping `import repro_torch.core` cycle-free.

    from repro_torch import tune
    report = tune.tune_routine("gemv", n=16384)
    exe = blas.compile(spec, tiles="auto")     # picks the winners up

What each `TileConfig` field drives on Hopper is the table in
`tune.config`. CLI: `python -m repro_torch.tune --smoke` (__main__.py).
"""
from __future__ import annotations

from .config import (EMPTY_PLAN, TileConfig, TilePlan,  # noqa: F401
                     candidates_for, clamp, current_device_kind,
                     shape_bucket)
from .store import (SCHEMA, SCHEMA_VERSION, TuningTable,  # noqa: F401
                    cache_dir, get_store, reset_store, validate_doc)

__all__ = [
    "EMPTY_PLAN", "SCHEMA", "SCHEMA_VERSION", "TileConfig", "TilePlan",
    "TuneReport", "TuningTable", "cache_dir", "candidates_for",
    "clamp", "current_device_kind", "get_store", "reset_store",
    "shape_bucket", "tune_program", "tune_routine", "validate_doc",
]

_LAZY = ("tune_program", "tune_routine", "TuneReport", "Measurement")


def __getattr__(name):
    if name in _LAZY:
        from . import autotuner
        return getattr(autotuner, name)
    raise AttributeError(
        f"module 'repro_torch.tune' has no attribute {name!r}")
