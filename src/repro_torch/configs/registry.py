"""Architecture registry: --arch <id> resolution (the port's own copy of
`repro/configs/registry.py`; pure data, no JAX)."""
from __future__ import annotations

import importlib

from .base import ArchConfig, InputShape, SHAPES, shape_cells  # noqa

_MODULES = {
    "minicpm3-4b": "minicpm3_4b",
    "llama3-8b": "llama3_8b",
    "starcoder2-3b": "starcoder2_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-125m": "xlstm_125m",
    "llava-next-34b": "llava_next_34b",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}
