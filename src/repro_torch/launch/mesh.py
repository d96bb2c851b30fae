"""Device meshes, the port of `repro/launch/mesh.py`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions, one process per rank:

Single pod: 16x16 = 256 ranks ("data", "model").
Multi-pod: 2 x 16 x 16 = 512 ranks ("pod", "data", "model"); the "pod"
dimension is pure data parallelism.

Each rank builds its mesh over a process group that the caller has
already initialised (`torch.distributed.init_process_group`, with its
own address, world size and rank); the collectives run on NCCL for
"cuda" meshes and on gloo for "cpu" ones. Meshes are made by
FUNCTIONS, so importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch

from ..kernels.common import resolve_device


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over ranks 0 .. 255 (or 511) on the cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, resolve_device(None).type)


def make_host_mesh(*, data: int = 1, model: int = 1, device=None):
    """A small ("data", "model") mesh over the initialised world (tests,
    examples): over its first data * model ranks, or (world, 1) where
    the world is smaller than that. On the card unless `device="cpu"`."""
    import torch.distributed as dist

    kind = resolve_device(device).type
    world = dist.get_world_size()
    if data * model > world:
        data, model = world, 1
    return _mesh((data, model), ("data", "model"), kind)
