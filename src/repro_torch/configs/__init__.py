"""Architecture and input-shape configurations: the port's own copy of
`repro/configs/`, which is pure data and imports no JAX. A CPU test holds
every config equal to the reference's, field by field."""
from .base import (ArchConfig, InputShape, MLAConfig, MoEConfig,  # noqa
                   SHAPES, SSMConfig, shape_cells)
from .registry import ARCH_NAMES, all_configs, get_config  # noqa
