"""Llama-3 8B — dense GQA decoder with a 128k vocab [arXiv:2407.21783]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    supports_long_context=False,
    notes="GQA 4:1, SwiGLU, full attention -> long_500k skipped.",
)
