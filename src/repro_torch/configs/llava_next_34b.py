"""LLaVA-NeXT-34B backbone [hf:llava-hf lineage] — the 34B language
tower; anyres vision tiling is a STUB (input_specs() supplies
precomputed patch embeddings concatenated with text embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    input_mode="embeddings",
    supports_long_context=False,
    notes="GQA 7:1; patch-embedding input stub (anyres tiling outside "
          "scope); full attention -> long_500k skipped.",
)
