"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, GQA, SWA.
Sliding window bounds decode state, so long_500k RUNS."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384,
                  capacity_factor=1.25),
    segments=(("attn_moe", 56),),
    window=4096,
    rope_theta=1000000.0,
    supports_long_context=True,
    notes="8 experts < 16-way model axis -> experts TP'd on d_ff "
          "instead of EP. SWA window 4096 (Mistral lineage).",
)
