#!/usr/bin/env python3
"""Time h2o-danube-3-4b's decode step (all 24 layers at full width,
random weights from seed 0, bfloat16) through the public entry points
`prefill` and `decode_step` of whichever tree of the port is on
PYTHONPATH, as `chip_smoke.py`'s phase 2f does: B 8 prompts drawn from
the same seed (lengths 1024-4080, the first 4080, so that decode crosses
the ring's W = 4096), prefill, then 31 steps, each between two CUDA
events with the host's issue time (from the call to the events' record
of the step's greedy token) beside it. Card only; it measures, and
checks nothing.

    PYTHONPATH=src python3 tools/time_decode_step.py [label]

One JSON line: the medians and the lists of the step's event ms and
host issue ms, then the card's name and power limit. To compare two
trees, run each in turns in one call (parent, change, change, parent).
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serve import pad_and_batch

ARCH, BATCH, STEPS, SEED = "h2o-danube-3-4b", 8, 32, 3
LENGTHS = (1024, 4080)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else None
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    rng = np.random.default_rng(SEED)
    plens = rng.integers(LENGTHS[0], LENGTHS[1] + 1, BATCH)
    plens[0] = LENGTHS[1]
    reqs = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in plens]
    ((prompts, _),) = pad_and_batch(reqs, BATCH)
    prompts = prompts.to(dev)
    max_len = prompts.shape[1] + STEPS
    model = init_params(cfg, 0, device=dev)
    logits, cache, pos = prefill(model, cfg, prompts, max_len)
    tok = logits.argmax(-1).to(torch.int32)
    lens = torch.full((BATCH,), pos + 1, dtype=torch.int32, device=dev)
    issue, step_ev = [], []
    for t in range(STEPS - 1):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        logits, cache = decode_step(model, cfg, tok, cache, pos + t,
                                    cache_len=lens)
        tok = logits.argmax(-1).to(torch.int32)
        ev1.record()
        issue.append((time.perf_counter() - t0) * 1e3)
        ev1.synchronize()
        step_ev.append(ev0.elapsed_time(ev1))
        lens.add_(1)
    print(json.dumps({"label": label, "arch": ARCH, "batch": BATCH,
                      "padded_len": int(prompts.shape[1]),
                      "steps": STEPS - 1,
                      "step_event_ms_median": median(step_ev),
                      "step_host_issue_ms_median": median(issue),
                      "step_event_ms": step_ev,
                      "step_host_issue_ms": issue}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
