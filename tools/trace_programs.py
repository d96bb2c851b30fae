#!/usr/bin/env python3
"""Where the time of a port call goes on one CUDA card: device time by
kernel, the card's idle share, and the host's time to issue each call.

    python3 tools/trace_programs.py        # from the root of a checkout

An investigation, not a check: `chip_smoke.py` holds every kernel to its
plain version; this script only measures, at the smoke's shapes, and
prints one JSON line per measurement, then the card's name and power
limit. For each call:

* `event_ms`: CUDA events over 20 calls after 3 warm-up calls;
* `host_ms`: host time to issue one call (no synchronisation inside the
  loop); where it reaches `event_ms` the host, not the card, sets the
  pace;
* for the programs (CG_MATVEC, GMRES_ORTH), a torch.profiler trace of
  10 calls: device time by kernel, the union of the kernel intervals
  (`device_busy_ms`, by `portbench.tracing.union`) and `idle_share` =
  1 - busy / wall, unclamped (tracing slows the host, so the share is
  an upper bound for the untraced call).

The AXPYDOT program is traced by the benchmark's `axpydot-stream` cell
(`python3 portbench/run.py --workload axpydot-stream ... --trace 1`).

The same for one block-CG iteration (`BLOCK_CG_LOOP`'s body on the
smoke's SPD system, n = 16384, s = 32) in dataflow and nodataflow: each
stage program of the body, and the whole body as the loop driver runs
it, without the status byte the driver reads after it. And for one
GMRES(20) restart (`GMRES_LOOP` on the smoke's non-symmetric system,
n = 16384): the restart's own stage programs (v0's scal, the transpose,
the residual), one step of each nested loop (an Arnoldi step, a Givens
step, a back-substitution step: every stage the step runs, reads,
stores and scalar lets included), and the whole restart. And for one
prefill and one decode step of the serve path (llama3-8b at full width
and depth in bfloat16, the smoke's 8 prompts left-padded to 1781
tokens; the step at position 1781 + 16).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 1 << 26
N2 = 16384
BASIS = (31, 1 << 20)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_programs: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import tracing
    from repro_torch.core import Program
    from repro_torch.kernels import cuda, ops
    from repro_torch.solvers import LoopProgram, specs

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cuda.build()
    x, y, z = randn(N), randn(N), randn(N)
    A = randn(N2, N2)
    A = (A + A.T).mul_(0.5)
    xa, ya = randn(N2), randn(N2)
    V, h, w = randn(*BASIS), randn(BASIS[0]), randn(BASIS[1])

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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issued = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return issued

    def trace(fn, reps=10):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
        spans, by_kernel = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            key = e.name[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + \
                e.time_range.elapsed_us() / reps
        if not spans:
            return {"traced_wall_ms": wall_ms,
                    "device_busy_ms": "not measured"}
        busy_ms = sum(b - a for a, b in tracing.union(spans)) / reps / 1e3
        return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms,
                "device_us_by_kernel": by_kernel}

    calls = {
        "axpy": lambda: ops.axpy(1.7, x, y),
        "dot": lambda: ops.dot(x, y),
        "axpydot": lambda: ops.axpydot(0.9, x, y, z),
        "gemv 16384^2": lambda: ops.gemv(1.3, A, xa, -0.7, ya),
        "gemvt 16384^2": lambda: ops.gemvt(1.3, A, xa, -0.7, ya),
        "symv 16384^2": lambda: ops.symv(1.3, A, xa, -0.7, ya),
        "gemv (31, 2^20)": lambda: ops.gemv(1.3, V, w, -0.7, h),
        "gemvt (31, 2^20)": lambda: ops.gemvt(1.3, V, h, -0.7, w),
    }
    for name, fn in calls.items():
        emit({"call": name, "event_ms": event_ms(fn),
              "host_ms": host_ms(fn)})

    programs = {
        "CG_MATVEC (16384^2)": (smoke.SOLVER_SPECS["CG_MATVEC"],
                                dict(A=A, p=xa)),
        "GMRES_ORTH (31, 2^20)": (smoke.SOLVER_SPECS["GMRES_ORTH"],
                                  dict(V=V, h=h, w=w)),
    }
    for name, (raw, inputs) in programs.items():
        for mode in ("dataflow", "nodataflow"):
            prog = Program.from_spec(raw, mode=mode, device="cuda")
            fn = (lambda p=prog, i=inputs: p(**i))
            emit({"program": name, "mode": mode, "event_ms": event_ms(fn),
                  "host_ms": host_ms(fn), **trace(fn)})

    # one block-CG iteration, stage by stage, on the smoke's system
    del A
    s = smoke.S_BLOCK
    a_spd = randn(N2, N2).div_(N2 ** 0.5)
    a_spd = (a_spd + a_spd.T).mul_(0.5)
    a_spd.diagonal().add_(2.0 ** 0.5 + 2.0 * 2.0 ** 0.5
                          / (smoke.KAPPA - 1.0))
    b = randn(N2, s)
    b /= b.norm(dim=0, keepdim=True)
    operands = dict(A=a_spd, B=b, x0=torch.zeros_like(b))
    for mode in ("dataflow", "nodataflow"):
        lp = LoopProgram(specs.BLOCK_CG_LOOP, mode=mode, device="cuda")
        lp.solve(**operands)         # builds every kernel of the loop
        state, _, scale = lp._init_state(operands)
        thr = torch.clamp_min(scale.float(), 1e-30) * 1e-6
        env = lp._body_env(state, thr)
        for cs in lp.lir.body:
            if cs.tag != "program":
                continue
            ins = {pub: env[src] for pub, src in cs.inputs.items()}
            fn = (lambda f=cs.ir.fn, i=ins: f(i))
            emit({"program": f"BLOCK_CG_LOOP body: {cs.ir.spec.name}",
                  "mode": mode, "event_ms": event_ms(fn),
                  "host_ms": host_ms(fn), **trace(fn)})
        fn = (lambda: lp._step_guarded(operands, state, thr, 0))
        emit({"program": "BLOCK_CG_LOOP iteration", "mode": mode,
              "event_ms": event_ms(fn), "host_ms": host_ms(fn),
              **trace(fn)})

    # one GMRES(20) restart, stage by stage, on the smoke's system: the
    # restart's own program stages, then one step of each nested loop
    del a_spd, b, operands
    a_g = randn(N2, N2).div_(N2 ** 0.5)
    a_g.diagonal().add_(smoke.GMRES_SHIFT)
    b_g = randn(N2)
    operands = dict(A=a_g, b=b_g, x0=torch.zeros_like(b_g))
    steps = {"j": "Arnoldi step", "t": "Givens step",
             "i": "back-substitution step"}
    for mode in ("dataflow", "nodataflow"):
        lp = LoopProgram(specs.GMRES_LOOP, mode=mode, device="cuda")
        lp.solve(**operands)         # builds every kernel of the loop
        state, _, scale = lp._init_state(operands)
        thr = torch.clamp_min(scale.float(), 1e-30) * 1e-6
        env = lp._body_env(state, thr)       # one whole restart
        for cs in lp.lir.body:
            if cs.tag == "program":
                ins = {pub: env[src] for pub, src in cs.inputs.items()}
                fn = (lambda f=cs.ir.fn, i=ins: f(i))
                name = f"GMRES restart: {cs.ir.spec.name}"
            elif cs.tag == "loop":
                inner = dict(env)
                inner.update(lp._init_fields(cs.stage.state, env, cs.copy))
                inner[cs.stage.counter] = smoke.GMRES_M // 2
                fn = (lambda c=cs, e=inner: lp._run_stages(c.body, dict(e)))
                name = f"GMRES restart: {steps[cs.stage.counter]}"
            else:
                continue
            emit({"program": name, "mode": mode, "event_ms": event_ms(fn),
                  "host_ms": host_ms(fn), **trace(fn)})
        fn = (lambda: lp._step_guarded(operands, state, thr, 0))
        emit({"program": "GMRES restart", "mode": mode,
              "event_ms": event_ms(fn, reps=5, warm=1),
              "host_ms": host_ms(fn, reps=5), **trace(fn, reps=3)})

    # the serve path: llama3-8b at full width and depth in bfloat16, the
    # smoke's 8 prompts; one prefill and one decode step in the middle of
    # the generation
    del a_g, b_g, operands
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import pad_and_batch

    cfg = get_config("llama3-8b")
    model = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(256, 2049, smoke.SERVE_BATCH)]
    ((prompts, _),) = pad_and_batch(reqs, smoke.SERVE_BATCH)
    prompts = prompts.to(dev)
    max_len = prompts.shape[1] + smoke.SERVE_NEW
    fn = (lambda: prefill(model, cfg, prompts, max_len))
    emit({"program": "serve llama3-8b prefill",
          "shape": list(prompts.shape), "event_ms": event_ms(fn, reps=3,
                                                             warm=1),
          "host_ms": host_ms(fn, reps=3), **trace(fn, reps=2)})
    logits, cache, pos = prefill(model, cfg, prompts, max_len)
    pos += smoke.SERVE_NEW // 2
    tok = logits.argmax(-1).to(torch.int32)
    lens = torch.full((smoke.SERVE_BATCH,), pos + 1, dtype=torch.int32,
                      device=dev)
    fn = (lambda: decode_step(model, cfg, tok, cache, pos, cache_len=lens))
    emit({"program": "serve llama3-8b decode step", "pos": pos,
          "event_ms": event_ms(fn), "host_ms": host_ms(fn), **trace(fn)})

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
