"""Training launcher, the port of `repro/launch/train.py`: the data
stream, the train step, checkpoints, the straggler watchdog and restart,
on one device.

    python -m repro_torch.launch.train --arch llama3-8b --reduced \\
        --device cpu                                           # host
    python -m repro_torch.launch.train --arch llama3-8b --reduced  # card

`--reduced` takes the config's small same-topology variant in float32;
without it the full config trains at its own dtype, with random weights
made on the device from the seed. With no `--device` it runs on the
card, and raises where there is none. Sharded training over a mesh of
more than one rank (the reference's `--production-mesh`, `--multipod`,
`mesh=`) is ROADMAP item 14.6b and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import make_stream
from ..ft import StragglerWatchdog
from ..kernels import common
from ..models import init_params
from ..optim import AdamW, cosine_schedule
from ..train import (load_state_tree, make_train_state, make_train_step,
                     state_tree)
from ..train.step import SHARDED


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
    given by the caller yields its batches on `device`."""
    if mesh is not None and mesh.mesh.numel() > 1:
        raise ValueError(f"train_loop: {SHARDED}")
    dev = common.resolve_device(device)
    optim = AdamW(lr=cosine_schedule(lr, warmup=min(100, steps // 10 + 1),
                                     total=steps))
    step_fn = make_train_step(cfg, optim, remat=remat)
    state = make_train_state(cfg, init_params(cfg, seed, device=dev), optim)

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
        state, metrics = step_fn(state, stream.batch_at(step))
        if (step + 1) % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step + 1, loss))
            dt = time.time() - t_step
            watchdog.record(step, dt)
            print(f"step {step + 1:5d} loss {loss:.4f} ({dt:.2f}s)")
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save(step + 1, state_tree(state))
        t_step = time.time()
    if manager is not None:
        manager.save(steps, state_tree(state), blocking=True)
    final_loss = losses[-1][1] if losses else float("nan")
    return TrainLoopResult(steps_run=steps - start, final_loss=final_loss,
                           losses=losses, restored_from=restored_from,
                           straggler_steps=watchdog.slow_steps)


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

    if args.production_mesh or args.multipod:
        raise SystemExit(SHARDED)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    device = common.resolve_device(args.device)
    t0 = time.time()
    res = train_loop(cfg, steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir, lr=args.lr,
                     device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"final loss: {res.final_loss:.4f} ({res.steps_run} steps in "
          f"{time.time() - t0:.2f}s on {device})")


if __name__ == "__main__":
    main()
