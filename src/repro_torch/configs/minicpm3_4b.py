"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B]. 62L, d_model 2560, 40 heads, d_ff 6400,
vocab 73448. MLA dims follow the HF config: q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v_head 64. Full attention -> long_500k skipped
(DESIGN.md §Arch-applicability).
"""
from .base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    tie_embeddings=True,
    supports_long_context=False,
    notes="MLA latent KV cache (kv_lora 256 + rope 32 per token).",
)
