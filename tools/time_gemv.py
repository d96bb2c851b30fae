#!/usr/bin/env python3
"""Time the public gemv entry point (`repro_torch.kernels.ops.gemv`) of
whichever tree of the port is on PYTHONPATH, beside torch.addmv, at the
main path's three float32 shapes: 16384^2, the (31, 2^20) basis and
GMRES(20)'s (21, 16384) basis. Card only; it measures, and checks only
that gemv agrees with addmv (within 1e-5 of each row's sum of |terms|).

    PYTHONPATH=src python3 tools/time_gemv.py [label]

Per shape and function: `ms`, 20 back-to-back calls after 3 warm-up
calls between CUDA events; `host_ms`, the host's time to issue one call
(no synchronisation inside the timed calls); and gemv's launches and
combine launches per call. One JSON line per shape; then `graph_ms`,
the same calls replayed from a CUDA graph (null, with the error, where
a tree's gemv cannot be captured), one line per shape; then the card's
name and power limit. To compare two trees, run each in turns in one
call (parent, change, change, parent).
"""
import json
import subprocess
import sys
import time

import torch

from repro_torch.kernels import cuda, ops

ALPHA, BETA = 1.3, -0.7
SHAPES = [(16384, 16384), (31, 1 << 20), (21, 16384)]


def event_ms(fn, reps=20, warm=3):
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


def host_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return issue


def graph_ms(fn, reps=20):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda")
    cuda.build(["gemv"])
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for m, n in SHAPES:
        a = torch.randn(m, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(m, generator=gen, device=dev)
        kfn = (lambda a=a, x=x, y=y: ops.gemv(ALPHA, a, x, BETA, y))
        lfn = (lambda a=a, x=x, y=y: torch.addmv(y, a, x, beta=BETA,
                                                  alpha=ALPHA))
        got, want = kfn().double(), lfn().double()
        tol = 1e-5 * abs(ALPHA) * (a.double().abs() @ x.double().abs()) \
            + 1e-6 * abs(BETA) * y.double().abs()
        agrees = bool(((got - want).abs() <= 2 * tol).all())
        launches = (ops.gemv.launches, ops.gemv.finish_launches)
        kfn()
        torch.cuda.synchronize()
        per_call = (ops.gemv.launches - launches[0],
                    ops.gemv.finish_launches - launches[1])
        row = {"tree": label, "shape": [m, n], "agrees_with_addmv": agrees,
               "launches_per_call": per_call[0],
               "combines_per_call": per_call[1],
               "bound_ms": 4 * (m * n + n + 2 * m) / 3.35e12 * 1e3,
               "ms": [event_ms(kfn)], "addmv_ms": [event_ms(lfn)],
               "host_ms": [host_ms(kfn)], "addmv_host_ms": [host_ms(lfn)]}
        row["addmv_ms"].append(event_ms(lfn))
        row["ms"].append(event_ms(kfn))
        row["addmv_host_ms"].append(host_ms(lfn))
        row["host_ms"].append(host_ms(kfn))
        print(json.dumps(row), flush=True)
        calls.append(([m, n], kfn, lfn))
    for shape, kfn, lfn in calls:
        row = {"tree": label, "shape": shape}
        try:
            row["graph_ms"] = [graph_ms(kfn), graph_ms(kfn)]
        except RuntimeError as err:       # the tree's gemv: not capturable
            row["graph_ms"], row["graph_error"] = None, str(err)[:300]
        row["addmv_graph_ms"] = [graph_ms(lfn), graph_ms(lfn)]
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
