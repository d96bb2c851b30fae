"""StarCoder2-3B — dense GQA decoder, RoPE [arXiv:2402.19173]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.0,
    act="gelu",
    supports_long_context=False,
    notes="GQA 12:1 (kv=2), gelu MLP, full attention -> long_500k "
          "skipped.",
)
