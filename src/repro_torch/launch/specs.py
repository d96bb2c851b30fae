"""Stand-ins for every input of a rank's call, the port of
`repro/launch/specs.py`.

The reference makes `ShapeDtypeStruct`s of the GLOBAL arrays, each with
its `NamedSharding`, and lowers its jitted steps against them. The port
runs one program per rank, so a stand-in here is this rank's block of
each tensor under its spec, on the `meta` device (no allocation), on a
`sharding.MeshShape` (no process group): the cost counter
(`launch.cost`) runs the rank's train step, prefill or decode step on
them. Each function returns (stand-ins, specs), the specs those of the
reference (the global tensors' `sharding` rules).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, InputShape
from ..core.distributed import shard
from ..models import model as M
from ..models import partition
from ..models import sharding as S
from ..optim import AdamW
from ..train import make_train_state

META = torch.device("meta")


def _block(mesh, shape, dtype, spec):
    """This rank's block under `spec` of a global tensor of `shape`."""
    return shard(mesh, torch.empty(shape, dtype=dtype, device=META), spec)


def _inputs(cfg: ArchConfig, mesh, shape, spec):
    """Token ids (int32) of `shape`, or bfloat16 embeddings with d_model
    added, as the reference's stand-ins."""
    if cfg.input_mode == "tokens":
        return _block(mesh, shape, torch.int32, spec)
    return _block(mesh, (*shape, cfg.d_model), torch.bfloat16, spec)


def params_struct(cfg: ArchConfig, mesh, *, style: str = "2d"):
    """A `Model` on meta holding this rank's block of every parameter
    (placed by `models.model.shard_model`), and {name: spec}."""
    model = M.shard_model(cfg, M.Model(cfg, device=META), mesh, style)
    return model, dict(model.layout.specs)


def train_state_struct(cfg: ArchConfig, mesh, optim: AdamW, *,
                       style: str = "2d"):
    """The train state of `train.make_train_state` on meta (the AdamW
    moments beside the parameters, the step), and its specs."""
    with partition.use_mesh(mesh), partition.parallelism_style(style):
        state = make_train_state(cfg, M.Model(cfg, device=META), optim)
    p_specs = dict(state["params"].layout.specs)
    return state, {"params": p_specs, "opt": {"m": p_specs, "v": p_specs},
                   "step": ()}


def train_batch_struct(cfg: ArchConfig, mesh, shape: InputShape, *,
                       style: str = "2d"):
    b, s = shape.global_batch, shape.seq_len
    specs = S.batch_specs(cfg, mesh, style=style)
    batch = {"inputs": _inputs(cfg, mesh, (b, s), specs["inputs"]),
             "labels": _block(mesh, (b, s), torch.int32, specs["labels"])}
    return batch, specs


def cache_struct(cfg: ArchConfig, mesh, shape: InputShape):
    """This rank's `CacheBlocks` of the decode cache of `shape` (its batch
    rows under `_dp_divides`, the attention caches' sequence dimension
    over "model"), and the global cache's `sharding.cache_specs`."""
    b, s = shape.global_batch, shape.seq_len
    whole = M.init_cache(cfg, b, s, device=META)
    specs = S.cache_specs(cfg, mesh, whole, batch=b)
    rows = _rows(mesh, b)
    layout = partition.Layout(mesh, "2d", {})
    return M.init_cache(cfg, rows, s, device=META, layout=layout), specs


def decode_input_struct(cfg: ArchConfig, mesh, shape: InputShape):
    b = shape.global_batch
    spec = S.decode_input_specs(cfg, mesh, batch=b)
    return _inputs(cfg, mesh, (b,), spec), spec


def prefill_input_struct(cfg: ArchConfig, mesh, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    specs = S.batch_specs(cfg, mesh, batch_divisible=_dp_divides(mesh, b))
    return _inputs(cfg, mesh, (b, s), specs["inputs"]), specs


def _dp_divides(mesh, batch: int) -> bool:
    n = 1
    sizes = S.mesh_sizes(mesh)
    for a in S.dp_axes(mesh):
        n *= sizes[a]
    return batch % n == 0


def _rows(mesh, batch: int) -> int:
    """The batch rows a rank serves: its block over the DP dimensions
    where they divide the batch, else all of them."""
    if not _dp_divides(mesh, batch):
        return batch
    sizes = S.mesh_sizes(mesh)
    for a in S.dp_axes(mesh):
        batch //= sizes[a]
    return batch
