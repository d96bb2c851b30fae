#!/usr/bin/env python3
"""Time the public mha entry point (`repro_torch.kernels.ops.mha`) of
whichever tree of the port is on PYTHONPATH at the serve path's prefill
layers, bfloat16, causal, as the models pass their operands:
llama3-8b (B 8, 32 query heads on 8, S 1781, D 128), h2o-danube-3-4b
(B 8, 32 on 8, S 4080, D 120, window 4096), musicgen-medium (B 8, 24
on 24, S 1685, D 64), llava-next-34b (B 4, 56 on 8, S 3176, D 128) and
minicpm3-4b's MLA (B 8, 40 on 40, S 1970, q and k 96, v 64). Card only;
it measures, and checks nothing. The sequence lengths are those of
`chip_smoke.py`'s seeded serve batches.

    PYTHONPATH=src python3 tools/time_mha.py [label]

One JSON line per layer: the route the tree takes, `ms` (20 calls
between CUDA events, after warm-up calls for at least half a second, so
that the card's clock has settled whatever ran before), or null with
the error where the tree refuses the operands; then the card's name and
power limit. To compare two trees, run each in turns in one call
(parent, change, change, parent).
"""
import json
import subprocess
import sys
import time

import torch

from repro_torch.kernels import attention as k_attn, ops

# (name, B, Hq, Hkv, S, d, dv, window); the MLA layer passes q and k
# contiguous (concatenated) and v as the up-projection's last columns
LAYERS = [("llama3-8b", 8, 32, 8, 1781, 128, 128, None),
          ("h2o-danube-3-4b", 8, 32, 8, 4080, 120, 120, 4096),
          ("musicgen-medium", 8, 24, 24, 1685, 64, 64, None),
          ("llava-next-34b", 4, 56, 8, 3176, 128, 128, None),
          ("minicpm3-4b", 8, 40, 40, 1970, 96, 64, None)]


def event_ms(fn, reps=20, warm_s=0.5):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
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


def operands(b, hq, hkv, s, d, dv, gen):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    if dv != d:          # MLA's prefill
        q, k = randn(b, hq, s, d), randn(b, hkv, s, d)
        v = randn(b, s, hkv, 64 + dv).transpose(1, 2)[..., 64:]
        return q, k, v
    return (randn(b, s, hq, d).transpose(1, 2),
            randn(b, s, hkv, d).transpose(1, 2),
            randn(b, s, hkv, dv).transpose(1, 2))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, hq, hkv, s, d, dv, window in LAYERS:
        q, k, v = operands(b, hq, hkv, s, d, dv, gen)
        row = {"label": label, "layer": name, "shape": [b, hq, hkv, s, d, dv],
               "window": window}
        try:
            row["route"] = k_attn.mha_route(q, k, v)
            row["ms"] = event_ms(lambda: ops.mha(q, k, v, window=window))
        except (ValueError, RuntimeError) as exc:
            row["ms"] = None
            row["error"] = str(exc).splitlines()[0][:200]
        print(json.dumps(row), flush=True)
        del q, k, v
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
