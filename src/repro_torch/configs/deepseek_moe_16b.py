"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE: 64 routed
experts (top-6) + 2 shared experts, first layer dense."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,          # dense first-layer FFN width
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408,
                  n_shared_experts=2, d_shared=2816,
                  first_dense_layers=1, capacity_factor=1.25),
    segments=(("attn", 1), ("attn_moe", 27)),
    rope_theta=10000.0,
    supports_long_context=False,
    notes="2 shared + 64 routed top-6 experts; EP over the model axis "
          "(64 % 16 == 0). Full attention -> long_500k skipped.",
)
