"""`repro_torch.tune` — the port's tile configurations and its persistent
tuning and compiled-artifact store (`~/.cache/repro_torch`, or
`REPRO_TORCH_CACHE_DIR`), apart from the reference package's.

The autotuner (`tune_program`, `tune_routine`, `TuneReport`), its CLI,
`tiles="auto"` resolution from the store and `Executable.tune` are
ROADMAP Queue 1, item 12: those names raise naming that item.
"""
from __future__ import annotations

from .config import (EMPTY_PLAN, TileConfig, TilePlan,  # noqa: F401
                     candidates_for, clamp, current_device_kind,
                     shape_bucket)
from .store import (SCHEMA, SCHEMA_VERSION, TuningTable,  # noqa: F401
                    cache_dir, get_store, reset_store, validate_doc)

__all__ = [
    "EMPTY_PLAN", "SCHEMA", "SCHEMA_VERSION", "TileConfig", "TilePlan",
    "TuningTable", "cache_dir", "candidates_for", "clamp",
    "current_device_kind", "get_store", "reset_store", "shape_bucket",
    "validate_doc",
]

# the reference's autotuner names, not ported yet
_AUTOTUNER = ("tune_program", "tune_routine", "TuneReport", "Measurement")


def __getattr__(name):
    if name in _AUTOTUNER:
        raise NotImplementedError(
            f"repro_torch.tune.{name}: the autotuner is not ported yet "
            f"(ROADMAP Queue 1, item 12)")
    raise AttributeError(
        f"module 'repro_torch.tune' has no attribute {name!r}")
