#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the card:
whole runs of the cell (set-up, window, check; no trace) over many seeds
with the program, then over a few with the control in the program's
place (the configuration's system's `use_control`), each judged by the
harness's own comparison. Not part of a run.

    python3 portbench/tools/calibrate.py --workload axpydot-stream \
        --seconds 10 --seeds 11 12 13 --control-seeds 21 22 23

Prints one JSON line a seed and side: `correct`, the compared numbers
beside their limits, the calls made.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.path.insert(0, str(ROOT / "portbench"))
    import run as bench_run
    bench_run.set_environment()
    import torch

    from portbench import core

    sides = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    controlled = False
    for side, seed in sides:
        t0 = time.perf_counter()
        run = core.prepare(args.workload, seed, args.seconds, False, "cuda")
        if side == "control" and not controlled:
            run.system.use_control()
            controlled = True
        line = core.execute(run, t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "checks": line["checks"],
                          "s": time.perf_counter() - t0}), flush=True)
        del run, line
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
