"""Parameters between the reference's pytree layout and the port's module.

The reference keeps its parameters as a pytree: {"embed" for token
inputs, "segments": [per segment, {name: array stacked over the
segment's layers on axis 0}], "final_norm", and "lm_head" unless the
embedding is tied}: a model of embedding inputs has no "embed" and
always an "lm_head". Given
that tree as numpy arrays, `params_from_numpy` builds the port's `Model`
holding the same values, so that the two packages compute the same
function in the tests; `params_to_numpy` goes back.

The reference's train state {"params", "opt": {"m", "v"}, "step"} holds
its AdamW moments as trees of the parameters' layout.
`train_state_from_numpy` builds the port's train state from one (the
`Model`, its parameters requiring grad; the moments float32 tensors
under the `Model`'s parameter names; the step an int), so that both
packages take the same step; `train_state_to_numpy` goes back.
`tree_to_named` and `named_to_tree` map any tree of that layout (a
gradient's, a moment's) to and from the parameter names.
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
    _put(model.final_norm, tree["final_norm"], "final_norm")
    for name in ("embed", "lm_head"):
        dst = getattr(model, name)
        if (dst is None) != (name not in tree):
            has = "has" if name in tree else "lacks"
            raise ValueError(f"{cfg.name}: input_mode={cfg.input_mode!r}, "
                             f"tie_embeddings={cfg.tie_embeddings}, but "
                             f"the tree {has} an {name}")
        if dst is not None:
            _put(dst, tree[name], name)
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

    tree = {"segments": [
                {name: np.stack([np32(b.p[name]) for b in blocks])
                 for name in block_shapes(model.cfg, kind)}
                for kind, blocks in model.segment_blocks()],
            "final_norm": np32(model.final_norm)}
    for name in ("embed", "lm_head"):
        if getattr(model, name) is not None:
            tree[name] = np32(getattr(model, name))
    return tree


def _slots(model: Model):
    """Each of the Model's parameter names with its place in the
    reference's tree: (key,) at the top, ("segments", segment, name,
    layer) for a block's."""
    slots = {"final_norm": ("final_norm",)}
    for name in ("embed", "lm_head"):
        if getattr(model, name) is not None:
            slots[name] = (name,)
    i = 0
    for si, (kind, blocks) in enumerate(model.segment_blocks()):
        for li in range(len(blocks)):
            for name in block_shapes(model.cfg, kind):
                slots[f"blocks.{i}.p.{name}"] = ("segments", si, name, li)
            i += 1
    return slots


def tree_to_named(model: Model, tree):
    """{parameter name: float32 numpy array} from a tree of the
    reference's parameter layout (its params, a gradient, a moment)."""
    out = {}
    for name, where in _slots(model).items():
        if where[0] == "segments":
            _, si, key, li = where
            out[name] = np.asarray(tree["segments"][si][key],
                                   dtype=np.float32)[li]
        else:
            out[name] = np.asarray(tree[where[0]], dtype=np.float32)
    return out


def named_to_tree(model: Model, named):
    """The reference's tree layout of {parameter name: tensor or array},
    as float32 numpy, each segment's layers stacked on axis 0."""
    def np32(t):
        if torch.is_tensor(t):
            return t.detach().float().cpu().numpy()
        return np.asarray(t, dtype=np.float32)

    slots = _slots(model)
    tree = {"segments": [{} for _ in model.cfg.segments]}
    stacks = {}
    for name, where in slots.items():
        if where[0] == "segments":
            _, si, key, li = where
            stacks.setdefault((si, key), []).append(np32(named[name]))
        else:
            tree[where[0]] = np32(named[name])
    for (si, key), layers in stacks.items():
        tree["segments"][si][key] = np.stack(layers)
    return tree


def train_state_from_numpy(cfg: ArchConfig, state, *, device=None):
    """The port's train state holding the reference train state's values
    (numpy arrays): a `Model` whose parameters require grad, the float32
    moments under its parameter names, the step as an int."""
    dev = common.resolve_device(device)
    model = params_from_numpy(cfg, state["params"], device=dev)
    for p in model.parameters():
        p.requires_grad_(True)
    opt = {key: {name: torch.from_numpy(arr.copy()).to(dev)
                 for name, arr in tree_to_named(model,
                                                state["opt"][key]).items()}
           for key in ("m", "v")}
    return {"params": model, "opt": opt, "step": int(state["step"])}


def train_state_to_numpy(state):
    """The reference's train state tree of the port's train state, as
    float32 numpy (the step an int32 array)."""
    model = state["params"]
    return {"params": params_to_numpy(model),
            "opt": {key: named_to_tree(model, state["opt"][key])
                    for key in ("m", "v")},
            "step": np.asarray(state["step"], dtype=np.int32)}
