"""Parameters between the reference's pytree layout and the port's module.

The reference keeps its parameters as a pytree: {"embed", "segments":
[per segment, {name: array stacked over the segment's layers on axis
0}], "final_norm", and "lm_head" unless the embedding is tied}. Given
that tree as numpy arrays, `params_from_numpy` builds the port's `Model`
holding the same values, so that the two packages compute the same
function in the tests; `params_to_numpy` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels import common
from .model import Model, block_shapes


def _put(dst: torch.Tensor, value, what: str) -> None:
    arr = np.array(value, dtype=np.float32)   # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: expected shape {tuple(dst.shape)}, got "
                         f"{arr.shape}")
    dst.copy_(torch.from_numpy(arr))


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree, *, device=None,
                      dtype=None) -> Model:
    """The port's Model holding the values of a reference parameter tree
    (numpy arrays; any float dtype, widened through float32)."""
    model = Model(cfg, device=common.resolve_device(device), dtype=dtype)
    _put(model.embed, tree["embed"], "embed")
    _put(model.final_norm, tree["final_norm"], "final_norm")
    if (model.lm_head is None) != ("lm_head" not in tree):
        has = "has" if "lm_head" in tree else "lacks"
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} "
                         f"but the tree {has} an lm_head")
    if model.lm_head is not None:
        _put(model.lm_head, tree["lm_head"], "lm_head")
    segs = tree["segments"]
    if len(segs) != len(cfg.segments):
        raise ValueError(f"{cfg.name}: {len(cfg.segments)} segments, the "
                         f"tree has {len(segs)}")
    for si, (seg, (kind, blocks)) in enumerate(zip(
            segs, model.segment_blocks())):
        names = set(block_shapes(cfg, kind))
        if set(seg) != names:
            raise ValueError(f"segment {si}: expected parameters "
                             f"{sorted(names)}, got {sorted(seg)}")
        for name in names:
            stacked = np.asarray(seg[name], dtype=np.float32)
            if stacked.shape[0] != len(blocks):
                raise ValueError(f"segment {si} {name}: {len(blocks)} "
                                 f"layers, got {stacked.shape[0]}")
            for li, block in enumerate(blocks):
                _put(block.p[name], stacked[li], f"segment {si} {name}")
    return model


def params_to_numpy(model: Model):
    """The reference's parameter tree of a Model, as float32 numpy."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    tree = {"embed": np32(model.embed),
            "segments": [
                {name: np.stack([np32(b.p[name]) for b in blocks])
                 for name in block_shapes(model.cfg, kind)}
                for kind, blocks in model.segment_blocks()],
            "final_norm": np32(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = np32(model.lm_head)
    return tree
