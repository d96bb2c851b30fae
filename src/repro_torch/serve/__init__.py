"""The serving engine of the port (batched prefill and decode over the
model's KV cache)."""
from .engine import GenerationResult, ServeEngine, pad_and_batch  # noqa
