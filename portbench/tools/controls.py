#!/usr/bin/env python3
"""Whole runs of a cell (set-up, window, check; no trace) with one of its
system's named controls in the program's place, one process on the card,
each judged by the harness's own comparison: the upper readings a
cell's limits are set from, where its system has more than one control
(`calibrate.py` runs the default one). Not part of a run.

    python3 portbench/tools/controls.py --workload gp-predict-pcg \
        --control cg --seconds 10 --seeds 21 22 23

Prints one JSON line a seed: `correct`, the compared numbers beside
their limits, the calls made and failed.
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
    ap.add_argument("--control", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.path.insert(0, str(ROOT / "portbench"))
    import run as bench_run
    bench_run.set_environment()
    import torch

    from portbench import core

    controlled = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = core.prepare(args.workload, seed, args.seconds, False, "cuda")
        if not controlled:
            run.system.use_control(kind=args.control)
            controlled = True
        line = core.execute(run, t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": line["correct"],
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
