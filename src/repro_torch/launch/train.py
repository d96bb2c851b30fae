"""Training launcher, the port of `repro/launch/train.py`: the data
stream, the train step, checkpoints, the straggler watchdog and restart,
on one device or over a mesh of ranks.

    python -m repro_torch.launch.train --arch llama3-8b --reduced \\
        --device cpu                                           # host
    python -m repro_torch.launch.train --arch llama3-8b --reduced  # card
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3-8b --reduced                  # 4 ranks, (4, 1) mesh
    torchrun ... --nnodes 16 --nproc-per-node 16 -m repro_torch.launch.train \\
        --arch llama3-8b --production-mesh          # 256 ranks, (16, 16)

`--reduced` takes the config's small same-topology variant in float32;
without it the full config trains at its own dtype, with random weights
made on the device from the seed. With no `--device` it runs on the
card, and raises where there is none. Under a launcher that sets the
usual `torch.distributed` environment (`MASTER_ADDR`, `MASTER_PORT`,
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) every rank joins one process group,
NCCL on the cards and gloo under `--device cpu` (never one for the
other), and trains on a ("data", "model") mesh of (world, 1), or on the
production mesh: `--production-mesh` (16 x 16, 256 ranks) or
`--multipod` (2 x 16 x 16 over ("pod", "data", "model"), 512 ranks); a
world of another size is refused before any process group starts.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..core.distributed import shard
from ..data import make_stream
from ..ft import StragglerWatchdog
from ..kernels import common
from ..models import init_params, partition
from ..models import sharding as S
from ..optim import AdamW, cosine_schedule
from ..train import (load_state_tree, make_train_state, make_train_step,
                     state_tree)
from .mesh import make_host_mesh, make_production_mesh


@dataclasses.dataclass
class TrainLoopResult:
    steps_run: int
    final_loss: float
    losses: list
    restored_from: Optional[int]
    straggler_steps: list


def train_loop(cfg, *, mesh=None, steps, batch_size, seq_len, ckpt_dir=None,
               ckpt_every=50, lr=3e-4, seed=0, remat=True, log_every=10,
               stream=None, device=None):
    """The train loop (also used by the tests): `steps` global steps from
    the newest valid checkpoint in `ckpt_dir`, if any; the losses of
    every `log_every`-th step and the last as (step, loss); a checkpoint
    every `ckpt_every` steps and a blocking one at the end. A `stream`
    given by the caller yields its global batches on `device`.

    With a `mesh` (a DeviceMesh over the initialised process group; the
    style is `partition.current_style()`) every rank of the mesh calls
    it: the state is placed under `param_specs`, each rank takes its
    block of every global batch under `batch_specs`, and the gradients
    are reduce-scattered onto the blocks (`grad_specs`). Checkpoints hold
    whole arrays: the state is gathered and rank 0 writes; a restore
    places them on whatever mesh the job restarts on, or on one device."""
    style = partition.current_style()
    if mesh is not None:
        blocks = partition.size_of(mesh, partition.dp_axes_of(mesh, style))
        if batch_size % blocks:
            raise ValueError(f"train_loop: a global batch of {batch_size} "
                             f"does not split into the mesh's {blocks} "
                             f"batch blocks")
    dev = common.resolve_device(device)
    optim = AdamW(lr=cosine_schedule(lr, warmup=min(100, steps // 10 + 1),
                                     total=steps))
    params = init_params(cfg, seed, device=dev)
    with partition.use_mesh(mesh):
        state = make_train_state(cfg, params, optim)
    specs = state["params"].layout.specs if mesh is not None else None
    step_fn = make_train_step(cfg, optim, remat=remat, grad_specs=specs)
    bspecs = (S.batch_specs(cfg, mesh, style=style) if mesh is not None
              else None)
    writer = mesh is None or dist.get_rank() == 0

    def local(batch):
        if bspecs is None:
            return batch
        return {k: shard(mesh, v, bspecs.get(k, bspecs["labels"]))
                for k, v in batch.items()}

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    restored_from = None
    start = 0
    if manager is not None:
        found, restored = manager.restore_latest(state_tree(state),
                                                 device=dev)
        if found is not None:
            load_state_tree(state, restored)
            restored_from, start = found, found
            print(f"[restore] resumed from step {found}")

    stream = stream or make_stream(cfg, seq_len=seq_len,
                                   batch_size=batch_size, seed=seed,
                                   device=dev)
    watchdog = StragglerWatchdog()
    losses = []
    t_step = time.time()
    for step in range(start, steps):
        state, metrics = step_fn(state, local(stream.batch_at(step)))
        if (step + 1) % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step + 1, loss))
            dt = time.time() - t_step
            watchdog.record(step, dt)
            if writer:
                print(f"step {step + 1:5d} loss {loss:.4f} ({dt:.2f}s)")
        if manager is not None and (step + 1) % ckpt_every == 0:
            tree = state_tree(state)
            if writer:
                manager.save(step + 1, tree)
        t_step = time.time()
    if manager is not None:
        tree = state_tree(state)
        if writer:
            manager.save(steps, tree, blocking=True)
        if mesh is not None:
            dist.barrier()
    final_loss = losses[-1][1] if losses else float("nan")
    return TrainLoopResult(steps_run=steps - start, final_loss=final_loss,
                           losses=losses, restored_from=restored_from,
                           straggler_steps=watchdog.slow_steps)


def _world_mesh(args, device):
    """The process group from the environment and the mesh over it, or
    None for a single process outside any launcher. The
    production meshes need exactly their 256 or 512 ranks: another world
    is refused before the group starts."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    production = args.production_mesh or args.multipod
    if production:
        need = 512 if args.multipod else 256
        if world != need:
            raise SystemExit(
                f"--{'multipod' if args.multipod else 'production-mesh'} "
                f"needs a world of {need} ranks (WORLD_SIZE), not {world}")
    elif "WORLD_SIZE" not in os.environ:
        return None
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", int(os.environ["RANK"]) % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method="env://")
    if production:
        return make_production_mesh(multi_pod=args.multipod,
                                    device=device.type)
    return make_host_mesh(data=world, model=1, device=device.type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    device = common.resolve_device(args.device)
    mesh = _world_mesh(args, device)
    t0 = time.time()
    try:
        res = train_loop(cfg, mesh=mesh, steps=args.steps,
                         batch_size=args.batch, seq_len=args.seq,
                         ckpt_dir=args.ckpt_dir, lr=args.lr,
                         device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if mesh is None or int(os.environ.get("RANK", "0")) == 0:
        print(f"final loss: {res.final_loss:.4f} ({res.steps_run} steps in "
              f"{time.time() - t0:.2f}s on {device})")


if __name__ == "__main__":
    main()
