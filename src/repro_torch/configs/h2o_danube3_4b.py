"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818 lineage]. SWA makes 500k decode state bounded, so the
long_500k cell RUNS for this arch."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    window=4096,
    rope_theta=10000.0,
    supports_long_context=True,
    notes="Mistral-style SWA (window 4096) on all layers; KV bounded.",
)
