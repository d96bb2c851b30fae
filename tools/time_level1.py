#!/usr/bin/env python3
"""Time the window walk's level-1 rows (PERF.md §6, rows 1-5) on the
card, on whichever tree of the port is on PYTHONPATH. Card only; it
measures and checks nothing.

    PYTHONPATH=src python3 tools/time_level1.py [label] [--rounds R]

At n = 2**26 float32: axpy, scal, waxpby, copy, vmul, rot (numbers as
scalars), dot, asum, nrm2, iamax, axpydot (a number as α) and the
AXPYDOT program's generated group (`Executable.run` with a 0-d device α
taken from a pool, as the benchmark's `axpydot-stream` gives it). Per
round and row: the device ms a call between CUDA events over 20 calls
after 3 warm-up calls (the events time the host's issue too where it is
slower than the card), and, for every row but the group, the same calls
captured in a CUDA graph and replayed (device time alone). One JSON line
with every round's values and their median and quartiles; then the
card's name and power limit.
To compare two trees, run each in turns in one call (parent, change,
change, parent).
"""
import json
import statistics
import subprocess
import sys

import torch

from repro_torch import blas
from repro_torch.core import AXPYDOT_SPEC
from repro_torch.kernels import ops

N = 1 << 26
REPS = 20


def event_ms(fn, reps=REPS, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=REPS):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def summary(values):
    q = statistics.quantiles(values, n=4)
    return {"runs": values, "median": statistics.median(values),
            "q1": q[0], "q3": q[2]}


def main() -> int:
    args = sys.argv[1:]
    rounds = 3
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    label = args[0] if args else "tree"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y, z = torch.randn(3, N, generator=gen, device=dev)
    pool = torch.rand(4096, generator=gen, device=dev).add_(0.5).neg_()
    exe = blas.compile(AXPYDOT_SPEC, device="cuda")
    calls = [0]

    def group():
        calls[0] += 1
        return exe.run(neg_alpha=pool[calls[0] % pool.shape[0]], w=x, v=y,
                       u=z)

    rows = {
        "axpy": lambda: ops.axpy(1.7, x, y),
        "scal": lambda: ops.scal(-0.3, x),
        "waxpby": lambda: ops.waxpby(0.5, x, -1.25, y),
        "copy": lambda: ops.copy(x),
        "vmul": lambda: ops.vmul(x, y),
        "rot": lambda: ops.rot(0.6, 0.8, x, y),
        "dot": lambda: ops.dot(x, y),
        "asum": lambda: ops.asum(x),
        "nrm2": lambda: ops.nrm2(x),
        "iamax": lambda: ops.iamax(x),
        "axpydot": lambda: ops.axpydot(0.9, x, y, z),
        "axpydot group": group,
    }
    out = {name: {"ms": [], "graph_ms": []} for name in rows}
    for _ in range(rounds):
        for name, fn in rows.items():
            out[name]["ms"].append(event_ms(fn))
            if name != "axpydot group":
                out[name]["graph_ms"].append(graph_ms(fn))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"label": label, "rounds": rounds, "n": N,
                      "nvidia_smi": smi,
                      **{name: {k: summary(v) for k, v in row.items() if v}
                         for name, row in out.items()}}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
