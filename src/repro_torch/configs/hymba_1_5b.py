"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head blocks: attention heads
and Mamba(SSD) heads run in PARALLEL on the same input, outputs are
mean-fused after per-branch normalization. SWA + SSM state -> long_500k
RUNS. Meta-tokens and the 3 full-attention layers are documented
simplifications (SWA everywhere, window 1024)."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    d_head=64,
    segments=(("hybrid", 32),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_ssm_heads=8),
    window=1024,
    supports_long_context=True,
    notes="parallel attn+mamba heads, mean fusion; ssm_state=16.",
)
