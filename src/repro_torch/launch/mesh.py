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


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over ranks 0 .. 255 (or 511): on the cards
    unless `device="cpu"` (gloo). The world must hold exactly its
    ranks."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks, not "
                         f"{dist.get_world_size()}")
    return _mesh(shape, names, resolve_device(device).type)


def make_host_mesh(*, data: int = 1, model: int = 1, pod=None,
                   device=None):
    """A small ("data", "model") mesh over the initialised world (tests,
    examples): over its first data * model ranks, or (world, 1) where
    the world is smaller than that; with `pod`, a ("pod", "data",
    "model") mesh of pod * data * model ranks. On the card unless
    `device="cpu"`."""
    import torch.distributed as dist

    kind = resolve_device(device).type
    world = dist.get_world_size()
    if pod is not None:
        if pod * data * model > world:
            raise ValueError(f"a ({pod}, {data}, {model}) mesh needs "
                             f"{pod * data * model} ranks; the world has "
                             f"{world}")
        return _mesh((pod, data, model), ("pod", "data", "model"), kind)
    if data * model > world:
        data, model = world, 1
    return _mesh((data, model), ("data", "model"), kind)
