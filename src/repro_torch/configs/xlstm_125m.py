"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, GPT-2 scale.
Recurrent state is O(1) in sequence length -> long_500k RUNS.

Block layout: xLSTM[x:y] notation from the paper; we use 9 mLSTM and
3 sLSTM blocks interleaved (m m m s) x 3 — documented simplification of
the paper's 7:1 placement at this depth.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,            # xLSTM blocks carry their own projections
    vocab_size=50304,
    segments=(("mlstm", 3), ("slstm", 1)) * 3,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_ssm_heads=4),
    supports_long_context=True,
    notes="matrix-memory mLSTM (chunked parallel scan) + scalar sLSTM "
          "(sequential scan); d_ff=0 — per-block up/down projections.",
)
