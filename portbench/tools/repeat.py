#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each run its own
process, and summarise them: for measuring the spread that sets a bound,
or trying a cell. Not part of a run.

    python3 portbench/tools/repeat.py --out chiprun_out/sets.jsonl \
        --seconds 10 --runs axpydot-stream:0:101,102,103

Each `--runs` item is `cell:trace:seed,seed,...[:label]`; runs of one
label are summarised together (a set). Every run's result line
(or its failure) is appended to `--out` with the run's wall seconds and
the last 2000 characters of its standard error; the summary gives, per
cell and trace, each metric's median and its spread (quartile distance
over the median, by `statistics.quantiles(values, n=4)`).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--timeout", type=float, default=1300)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for item in args.runs:
        cell, trace, seeds, *label = item.split(":")
        label = label[0] if label else ""
        for seed in seeds.split(","):
            cmd = [sys.executable, "portbench/run.py", "--workload", cell,
                   "--seed", seed, "--seconds", str(args.seconds),
                   "--trace", trace]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                line = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                line = None
            row = {"cell": cell, "trace": int(trace), "seed": int(seed),
                   "label": label,
                   "rc": p.returncode, "wall_s": wall, "line": line,
                   "stderr": p.stderr[-2000:]}
            rows.append(row)
            with out.open("a") as f:
                f.write(json.dumps(row) + "\n")
            brief = ({k: v["value"] for k, v in line["metrics"].items()}
                     if line else None)
            print(json.dumps({"cell": cell, "trace": int(trace),
                              "seed": int(seed), "rc": p.returncode,
                              "wall_s": round(wall, 1),
                              "correct": line and line["correct"],
                              "checks": line and line.get("checks"),
                              "metrics": brief}), flush=True)
            if p.returncode:
                print(p.stderr[-3000:], file=sys.stderr, flush=True)
    groups = {}
    for r in rows:
        if r["line"]:
            for k, v in r["line"]["metrics"].items():
                groups.setdefault((r["cell"], r["trace"], r["label"], k),
                                  []).append(v["value"])
    for (cell, trace, label, k), vals in sorted(groups.items()):
        print(json.dumps({"summary": cell, "trace": trace, "set": label,
                          "metric": k,
                          "n": len(vals), "median": statistics.median(vals),
                          "spread": spread(vals), "values": vals}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
