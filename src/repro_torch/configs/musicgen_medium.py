"""MusicGen-medium backbone [arXiv:2306.05284] — decoder-only
transformer over EnCodec tokens. The EnCodec frontend is a STUB:
input_specs() supplies precomputed (B, S, d_model) frame embeddings;
the head predicts the 2048-entry codebook."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    input_mode="embeddings",
    supports_long_context=False,
    notes="MHA (kv=24), frame-embedding input stub, full attention -> "
          "long_500k skipped.",
)
