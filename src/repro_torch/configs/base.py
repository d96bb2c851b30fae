"""Architecture + shape configuration dataclasses.

Every assigned architecture is a frozen ArchConfig; input-shape cells
are InputShape instances. `reduced()` derives the CPU-smoke-test config
from the full one (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style multi-head latent attention dims."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden size
    n_shared_experts: int = 0
    d_shared: int = 0        # shared-expert hidden size (total)
    first_dense_layers: int = 0   # leading layers use a dense FFN
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    n_ssm_heads: int = 0     # 0 = derive from d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    attn_kind: str = "gqa"                # gqa | mla
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # block layout: sequence of (kind, count) segments; kinds:
    #   "attn"   — attention + FFN (dense or MoE per layer index)
    #   "mlstm"  — xLSTM matrix-memory block
    #   "slstm"  — xLSTM scalar-memory block
    #   "hybrid" — parallel attention + SSM heads (Hymba)
    segments: Tuple[Tuple[str, int], ...] = ()
    window: Optional[int] = None          # SWA window (None = full attn)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"                     # mlp activation (glu gate)
    input_mode: str = "tokens"            # tokens | embeddings
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which shape cells apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False
    notes: str = ""

    def __post_init__(self):
        if not self.segments:
            object.__setattr__(
                self, "segments", (("attn", self.n_layers),))
        total = sum(c for _, c in self.segments)
        assert total == self.n_layers, (self.name, total, self.n_layers)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline)."""
        d, L = self.d_model, self.n_layers
        p = 0
        if self.input_mode == "tokens":
            p += self.vocab_size * d
        p += self.vocab_size * d  # lm head (tied or not, count once if tied)
        if not self.tie_embeddings and self.input_mode == "tokens":
            pass  # already counted both above
        per_seg = {}
        for kind, count in self.segments:
            per_seg[kind] = per_seg.get(kind, 0) + count
        hd = self.head_dim
        for kind, count in per_seg.items():
            if kind in ("attn", "attn_moe"):
                if self.attn_kind == "mla":
                    m = self.mla
                    attn = (d * m.q_lora_rank
                            + m.q_lora_rank * self.n_heads * m.qk_head_dim
                            + d * (m.kv_lora_rank + m.qk_rope_dim)
                            + m.kv_lora_rank * self.n_heads
                            * (m.qk_nope_dim + m.v_head_dim)
                            + self.n_heads * m.v_head_dim * d)
                else:
                    attn = (d * self.n_heads * hd
                            + 2 * d * self.n_kv_heads * hd
                            + self.n_heads * hd * d)
                p += count * attn
                # ffn params counted per layer below (moe-aware)
            elif kind == "mlstm":
                dm = 2 * d
                p += count * (2 * d * dm + dm * d + 3 * dm * dm // 4)
            elif kind == "slstm":
                p += count * (4 * d * d + 4 * d * d + 2 * d * 4 * d // 3)
            elif kind == "hybrid":
                attn = (d * self.n_heads * hd
                        + 2 * d * self.n_kv_heads * hd)
                s = self.ssm or SSMConfig()
                dss = s.expand * d
                ssm = d * 2 * dss + dss * d + dss * (2 * s.d_state + 2)
                p += count * (attn + ssm + self.n_heads * hd * d)
                p += count * 2 * 3 * d * self.d_ff  # hymba keeps an FFN
        # FFN / MoE params: "attn" segments carry dense FFNs,
        # "attn_moe" segments carry the routed experts
        dense_l = per_seg.get("attn", 0)
        moe_l = per_seg.get("attn_moe", 0)
        p += dense_l * 3 * d * self.d_ff
        if moe_l and self.moe is not None:
            mo = self.moe
            p += moe_l * (mo.n_experts * 3 * d * mo.d_expert
                          + (3 * d * mo.d_shared
                             if mo.n_shared_experts else 0)
                          + d * mo.n_experts)
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE-aware), for 6·N_active·D."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        full = self.n_params()
        moe_l = sum(c for k, c in self.segments if k == "attn_moe")
        all_experts = moe_l * mo.n_experts * 3 * self.d_model * mo.d_expert
        active = moe_l * mo.top_k * 3 * self.d_model * mo.d_expert
        return full - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology config for CPU smoke tests."""
        scale_heads = max(1, self.n_heads // self.n_kv_heads)
        n_kv = min(self.n_kv_heads, 2)
        n_heads = n_kv * min(scale_heads, 2)
        segs = tuple((k, 1) for k, _ in self.segments)
        n_layers = len(segs)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8)
        moe = None
        if self.moe is not None:
            moe = MoEConfig(
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=32,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_shared=32 if self.moe.n_shared_experts else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                capacity_factor=2.0)
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(d_state=4, d_conv=self.ssm.d_conv,
                            expand=2, n_ssm_heads=2)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=64, n_heads=n_heads,
            n_kv_heads=n_kv, d_head=16, d_ff=128, vocab_size=256,
            segments=segs, mla=mla, moe=moe, ssm=ssm,
            window=min(self.window, 16) if self.window else None)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_cells(cfg: ArchConfig):
    """The (arch x shape) cells that apply to this architecture."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return [SHAPES[c] for c in cells]
