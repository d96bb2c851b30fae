#!/usr/bin/env python3
"""Time gemv's grid choices on one CUDA card (card only; measures and
checks nothing: each plan's largest difference from the result of the
plan that `kernels/gemv.py::gemv_plan` picks is printed beside it).

    PYTHONPATH=src python3 tools/sweep_gemv.py

For each shape, the plan that `gemv_plan` picks and others around it
(other column chunks and ring depths; for 16384^2 the band kernel
with one chunk against one warp per row), each as device time per call from a
CUDA-graph replay of 20 calls, twice in turns, beside torch.addmv.
Then the picked plan of (31, n) float32 for n = 2^17 .. 2^21, with the
fixed time and the rate of a least-squares line through those points.
Prints the registers and spills of csrc/gemv.cu's kernels, one JSON
line per shape, the scaling line, then the card's name and power
limit.
"""
import dataclasses
import json
import subprocess
import sys

import torch

from repro_torch.kernels import common, cuda, gemv as k_gemv

ALPHA, BETA = 1.3, -0.7


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


def variants(m, n, itemsize, sms):
    """(label, plan, route or None for the tensor's own) to time."""
    picked = k_gemv.gemv_plan(m, n, itemsize, sms)
    out = [("picked", picked, None)]
    if not picked.band:
        for rows in (32, 8):
            band = k_gemv.GemvPlan(rows, 1, picked.tiles,
                                   common.cdiv(m, rows), True, 4)
            out.append((f"band_{rows}_rows_1_chunk", band, "tma"))
        return out
    bands = picked.blocks // picked.chunks
    even = 1 << (sms.bit_length() - 1)      # a power of two up to sms
    counts = {picked.chunks, sms // 2, sms, 3 * sms // 2, 2 * sms, 3 * sms,
              even, 2 * even, picked.tiles // 8, picked.tiles // 4,
              picked.tiles // 2, picked.tiles}
    for chunks in sorted(c for c in counts if 1 <= c <= picked.tiles):
        depths = (2, 3, 4, 6, 8) if chunks in (sms, 2 * sms) else (4, 8)
        for stages in depths:
            plan = dataclasses.replace(picked, chunks=chunks,
                                       blocks=bands * chunks, stages=stages)
            if plan != picked:
                out.append((f"chunks_{chunks}_stages_{stages}", plan, None))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cuda.build(["gemv"])
    print(json.dumps({"ptxas": cuda.ptxas_report("gemv")}), flush=True)
    sms = common.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(31, 2 ** 20, torch.float32), (21, 16384, torch.float32),
              (31, 2 ** 20, torch.bfloat16), (16384, 16384, torch.float32)]
    for m, n, dtype in shapes:
        a = torch.randn(m, n, generator=gen, device=dev).to(dtype)
        x = torch.randn(n, generator=gen, device=dev).to(dtype)
        y = torch.randn(m, generator=gen, device=dev).to(dtype)
        size = a.element_size()
        plans = variants(m, n, size, sms)
        ref = None
        row = {"shape": [m, n], "dtype": str(dtype).split(".")[-1],
               "sms": sms, "bound_ms": size * (m * n + n + 2 * m)
               / 3.35e12 * 1e3, "plans": {}}
        for label, plan, route in plans:
            route = route or k_gemv.gemv_route(a, x, plan)

            def call(plan=plan, route=route):
                return k_gemv.gemv_launch(ALPHA, a, x, BETA, y, plan, route)

            got = call()
            if ref is None:
                ref = got
            err = float((got.double() - ref.double()).abs().max())
            row["plans"][label] = {"plan": str(plan), "route": route,
                                   "max_abs_diff_vs_picked": err,
                                   "graph_ms": [graph_ms(call)]}
        lib = (lambda: torch.addmv(y, a, x, beta=BETA, alpha=ALPHA))
        row["addmv_graph_ms"] = [graph_ms(lib)]
        for label, _, _ in reversed(plans):      # the second turn
            entry = row["plans"][label]
            plan = next(p for lb, p, _ in plans if lb == label)
            entry["graph_ms"].append(graph_ms(
                lambda: k_gemv.gemv_launch(ALPHA, a, x, BETA, y, plan,
                                           entry["route"])))
        row["addmv_graph_ms"].append(graph_ms(lib))
        print(json.dumps(row), flush=True)
        del a, x, y, ref
    # the picked plan of (31, n) float32 as n grows: the time's fixed part
    # and its rate, from a least-squares line through the points
    points = []
    for k in range(17, 22):
        n = 1 << k
        a = torch.randn(31, n, generator=gen, device=dev)
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(31, generator=gen, device=dev)
        plan = k_gemv.gemv_plan_for(a)
        route = k_gemv.gemv_route(a, x, plan)
        ms = min(graph_ms(lambda: k_gemv.gemv_launch(
            ALPHA, a, x, BETA, y, plan, route)) for _ in range(2))
        points.append((4 * (31 * n + n + 62), ms))
        del a, x, y
    mb = sum(b for b, _ in points) / len(points)
    mt = sum(t for _, t in points) / len(points)
    slope = (sum((b - mb) * (t - mt) for b, t in points)
             / sum((b - mb) ** 2 for b, _ in points))
    print(json.dumps({"scaling": "(31, n) float32, picked plans",
                      "points_bytes_ms": points,
                      "fixed_ms": mt - slope * mb,
                      "rate_tb_per_s": 1e-9 / slope}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
