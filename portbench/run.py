#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` on this machine's CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, kernel builds, inputs made
from the seed, a warm-up of the cell's own shapes) counts as `setup_s`;
then the program is driven for `--seconds`. With `--trace 1` a second
window of the same length runs under `torch.profiler` for the per-layer
metrics. Every answer is then held to the plain reference
(`portbench/reference.py`), and the last lines of standard error and the
result's `checks` give each compared number beside its limit. The last
line of standard output is the result, one JSON object.

Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), without the port's sources, or when JAX
or the JAX package got loaded. Kernel builds and Triton's cache stay in
`build/` inside the checkout; the tuning store goes under the run's
`XDG_CACHE_HOME` (else `HOME`).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def set_environment() -> None:
    """Fix every cache of the program before anything imports it."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build)
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TRITON_HOME"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    os.environ["REPRO_TORCH_CACHE_DIR"] = os.path.join(cache, "repro_torch")
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the port's sources (src/repro_torch) are not in "
              "this checkout", file=sys.stderr)
        return 2
    set_environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import core, manifest as mf

    cell = mf.cell(mf.load(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    run = core.prepare(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", root=ROOT)
    line = core.execute(run, T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
