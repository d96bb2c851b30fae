"""The port's checkpoint manager (`repro/checkpoint/`)."""
from .manager import CheckpointManager  # noqa: F401
