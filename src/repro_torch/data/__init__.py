"""The port's data pipeline (`repro/data/`)."""
from .pipeline import (EmbeddingStream, SyntheticLM,  # noqa: F401
                       TokenFileDataset, make_stream)
