"""The port's optimizer (`repro/optim/`): AdamW with float32 moments,
the cosine schedule, and int8 gradient compression."""
from .adamw import AdamW, cosine_schedule, global_norm  # noqa: F401
from . import compress  # noqa: F401
