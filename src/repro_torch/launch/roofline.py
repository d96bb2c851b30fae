"""Roofline terms of one rank's call, the port of
`repro/launch/roofline.py`.

  compute term    = flops / peak FLOP/s            (per rank)
  memory term     = HBM bytes / HBM bandwidth      (per rank)
  collective term = collective bytes / link rate   (per rank)

The flops and bytes come from the port's cost counter (`launch.cost`),
which counts one rank's train step, prefill or decode step as it runs on
`meta` stand-ins: the port compiles no XLA, so there is no compiled
artifact and no XLA cost analysis beside it (`xla_cost_reference` is
None).

Score reported per cell:
  roofline_fraction = t_ideal / t_bound, where
    t_ideal = max(model_flops / chips / peak, min_bytes / HBM bandwidth)
      -- the time physics requires for the USEFUL work (6·N·D compute,
        one pass over weights + cache + activations), and
    t_bound = max(compute, memory, collective terms).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM5, per GPU (the constants PERF.md's bounds use)
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
# The slowest link a collective of the production meshes crosses: each
# of their axes spans 16 GPUs, more than the 8 that NVLink joins in an
# H100 node, so its traffic leaves the node over the GPU's own
# inter-node NIC: one 400 Gb/s NDR InfiniBand port per GPU (NVIDIA
# DGX H100 reference architecture: eight ConnectX-7 400 Gb/s ports for
# eight GPUs), 50e9 bytes/s.
LINK_BW = 50e9               # bytes/s per GPU


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-rank flops (counted)
    hbm_bytes: float             # per-rank bytes accessed
    coll_bytes: float            # per-rank collective bytes received
    coll_detail: Dict[str, float]
    model_flops: float           # 6*N*D (global, useful)
    min_bytes: float             # per-rank unavoidable HBM traffic
    chips: int
    xla_cost: Optional[dict] = None   # no XLA here: always None

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / LINK_BW

    @property
    def t_bound(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_ideal(self):
        t_c = (self.model_flops / self.chips) / PEAK_FLOPS
        t_m = self.min_bytes / HBM_BW
        return max(t_c, t_m)

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        return self.t_ideal / self.t_bound if self.t_bound else 0.0

    def as_dict(self):
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_detail": self.coll_detail,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_ideal_s": self.t_ideal,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "min_bytes_per_device": self.min_bytes,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "xla_cost_reference": self.xla_cost,
        }


def analyze(cost, *, model_flops: float, chips: int,
            min_bytes: float) -> Roofline:
    """The roofline of a rank's counted call (`launch.cost.Cost`)."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                    coll_bytes=cost.coll_bytes,
                    coll_detail=dict(cost.coll_detail),
                    model_flops=model_flops, min_bytes=min_bytes,
                    chips=chips)


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode D = batch tokens."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
