#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero without the final line:

1. every kernel of the slice (row 1-4 of the TPU kernel table in
   PERF.md) against its plain PyTorch version on the card, at
   n = 2**26 float32, at the ragged n = 2**26 - 37, in bfloat16 for axpy
   and dot, and the iamax first-occurrence rule on ties across blocks;
2. the main path, with every launch counter set to 0 just before each
   part and read just after: `Program.from_spec(AXPYDOT_SPEC)` in the
   dataflow, nodataflow and reference modes, the wider generated group
   waxpby -> scal -> {dot, nrm2, iamax}, and the public `ops` entry
   points, all at n = 2**26;
3. bitwise repeatability of the dataflow program;
4. times from CUDA events (warm-up, then many launches over vectors
   larger than the 50 MB L2) beside each kernel's bound, its plain
   version and the one PyTorch call that computes the same function.

Then the `kernels` line, the card's name and power limit, and the
`{"ok": true, ...}` line. Tolerances:
* float32 reductions: |got - want| <= 1e-5 * sum|terms| (another
  summation order), with `want` also computed in float64;
* element-wise float32: 1e-6 of the operands' scale (a fused
  multiply-add may round once where the plain version rounds twice);
* bfloat16, compared in bfloat16: one bfloat16 unit in the last place
  (2**-8) of the operands' scale.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N = 1 << 26
RAGGED = N - 37
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import triton

    from repro_torch.core import AXPYDOT_SPEC, Program, codegen
    from repro_torch.kernels import (axpy as k_axpy, axpydot as k_axpydot,
                                     common, dot as k_dot, ops, window)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit({"phase": "header", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": triton.__version__, "n": N})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(n=N, dtype=torch.float32):
        return torch.randn(n, generator=gen, device=dev).to(dtype)

    x, y, z = randn(), randn(), randn()
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    wrappers = list(ops.KERNELS.values()) + [codegen.group_kernel]
    errors: dict = {}
    first_call_s: dict = {}

    # ------------------------------------------------------------------
    # 1. each kernel against its plain version
    # ------------------------------------------------------------------
    eltwise = {
        "axpy": ((1.7,), 2), "scal": ((-0.3,), 1),
        "waxpby": ((0.5, -1.25), 2), "copy": ((), 1), "vmul": ((), 2),
        "rot": ((0.6, 0.8), 2)}

    def eltwise_call(fn, scalars, vecs):
        if fn.__name__.startswith("waxpby"):   # (alpha, x, beta, y)
            return fn(scalars[0], vecs[0], scalars[1], vecs[1])
        return fn(*scalars, *vecs)

    def timed_first(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_call_s.setdefault(name, time.perf_counter() - t0)
        return out

    for name, (scalars, k) in eltwise.items():
        plain = getattr(k_axpy, f"{name}_plain")
        cases = [("f32", (x, y)[:k]), ("f32 ragged",
                                         (x[:RAGGED], y[:RAGGED])[:k])]
        if name == "axpy":
            cases.append(("bf16", (xb, yb)))
        for case, vecs in cases:
            got = timed_first(name, lambda: eltwise_call(
                ops.KERNELS[name], scalars, vecs))
            want = eltwise_call(plain, scalars, vecs)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            scale = (1.0 + sum(abs(s) for s in scalars)) * max(
                float(v.float().abs().max()) for v in vecs)
            ulp = 2.0 ** -8 if case == "bf16" else 1e-6
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            check(all(g.dtype == vecs[0].dtype and g.shape == vecs[0].shape
                      for g in got), f"{name} {case}: dtype/shape")
            ok = err <= ulp * scale
            emit({"phase": "kernel_vs_plain", "kernel": name, "case": case,
                  "max_abs_err": err, "tol": ulp * scale, "ok": ok})
            check(ok, f"{name} {case}: err {err} > {ulp * scale}")
            errors[name] = max(errors.get(name, 0.0), err)

    def f64_terms(name, vecs, alpha=0.9):
        """(exact value, sum of |terms|) in float64."""
        v = [t.double() for t in vecs]
        if name == "dot":
            t = v[0] * v[1]
            return float(t.sum()), float(t.abs().sum())
        if name == "asum":
            return float(v[0].abs().sum()), float(v[0].abs().sum())
        if name == "nrm2":
            s = float((v[0] * v[0]).sum())
            return s ** 0.5, s ** 0.5
        t = (v[0] - alpha * v[1]) * v[2]   # axpydot
        return float(t.sum()), float(t.abs().sum())

    reductions = {"dot": 2, "asum": 1, "nrm2": 1, "axpydot": 3}
    for name, k in reductions.items():
        cases = [("f32", (x, y, z)[:k]),
                 ("f32 ragged", (x[:RAGGED], y[:RAGGED], z[:RAGGED])[:k])]
        if name == "dot":
            cases.append(("bf16", (xb, yb)))
        for case, vecs in cases:
            if name == "axpydot":
                got = timed_first(name, lambda: ops.axpydot(0.9, *vecs))
                want = k_axpydot.axpydot_plain(0.9, *vecs)
            else:
                got = timed_first(name, lambda: getattr(ops, name)(*vecs))
                want = getattr(k_dot, f"{name}_plain")(*vecs)
            exact, mag = f64_terms(name, vecs)
            tol = 1e-5 * mag
            err = abs(float(got) - float(want))
            err64 = abs(float(got) - exact)
            ok = got.dtype == torch.float32 and err <= tol and err64 <= tol
            emit({"phase": "kernel_vs_plain", "kernel": name, "case": case,
                  "max_abs_err": err, "err_vs_f64": err64, "tol": tol,
                  "ok": ok})
            check(ok, f"{name} {case}: err {err}/{err64} > {tol}")
            errors[name] = max(errors.get(name, 0.0), err)

    # the generated group kernel of AXPYDOT_SPEC's dataflow plan
    neg_alpha = -0.7
    programs = {m: Program.from_spec(AXPYDOT_SPEC, mode=m, device="cuda")
                for m in ("dataflow", "nodataflow", "reference")}
    prog = programs["dataflow"]
    group_run = codegen.make_group_callable(
        prog.graph, prog.groups[0], torch.float32)
    group_scalars = {k: neg_alpha for k in group_run.signature.scalar_keys}
    check(set(group_run.signature.vec_in_keys) == {
        ("zcalc", "x"), ("zcalc", "y"), ("zdot", "y")},
        "axpydot group signature")

    def group_vecs(w, v, u):
        return {("zcalc", "x"): v, ("zcalc", "y"): w, ("zdot", "y"): u}

    for case, vecs in (("f32", (x, y, z)),
                       ("f32 ragged", (x[:RAGGED], y[:RAGGED],
                                       z[:RAGGED]))):
        got = timed_first("group_kernel", lambda: group_run(
            group_scalars, group_vecs(*vecs)))[("zdot", "out")]
        want = group_run.plain(group_scalars,
                               group_vecs(*vecs))[("zdot", "out")]
        exact, mag = f64_terms("axpydot", vecs, alpha=-neg_alpha)
        tol = 1e-5 * mag
        err, err64 = abs(float(got) - float(want)), abs(float(got) - exact)
        ok = err <= tol and err64 <= tol
        emit({"phase": "kernel_vs_plain", "kernel": "group_kernel",
              "case": case, "max_abs_err": err, "err_vs_f64": err64,
              "tol": tol, "ok": ok})
        check(ok, f"group kernel {case}: err {err}/{err64} > {tol}")
        errors["group_kernel"] = max(errors.get("group_kernel", 0.0), err)

    tie = torch.zeros(N, device=dev)
    b, fb = window.BLOCK, window.FINISH_BLOCK
    first = (fb + 6) * b + 17      # lane 6 of the second combine step
    for pos, val in ((first, 7.0), (first + 100, -7.0),
                     ((2 * fb + 6) * b + 3, 7.0), (3000 * b + 9, -7.0),
                     (5, 6.5)):
        tie[pos] = val
    iamax_cases = [("f32", x), ("f32 ragged", x[:RAGGED]),
                   ("ties across blocks", tie)]
    for case, vec in iamax_cases:
        got = int(timed_first("iamax", lambda: ops.iamax(vec)))
        want = int(k_dot.iamax_plain(vec))
        ok = got == want and (case != "ties across blocks" or got == first)
        emit({"phase": "kernel_vs_plain", "kernel": "iamax", "case": case,
              "got": got, "want": want, "ok": ok})
        check(ok, f"iamax {case}: {got} != {want}")
    errors["iamax"] = 0.0

    # ------------------------------------------------------------------
    # 2. the main path, counted
    # ------------------------------------------------------------------
    launches = {w.__name__: 0 for w in wrappers}
    finishes = {w.__name__: 0 for w in wrappers}

    def counted_run(fn):
        common.reset_counts(*wrappers)
        out = fn()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        for w in wrappers:
            launches[w.__name__] += w.launches
            finishes[w.__name__] += w.finish_launches
            check(w.plain_calls == 0, f"{w.__name__} ran its plain "
                                      f"version on the card")
        return out, counts

    axpydot_inputs = dict(neg_alpha=neg_alpha, w=x, v=y, u=z)
    exact, mag = f64_terms("axpydot", (x, y, z), alpha=-neg_alpha)
    expected = {"dataflow": {"group_kernel": 1},
                "nodataflow": {"axpy": 1, "dot": 1}, "reference": {}}
    betas = {}
    for mode, prog in programs.items():
        out, counts = counted_run(lambda: prog(**axpydot_inputs))
        betas[mode] = out["beta"]
        nonzero = {k: c for k, c in counts.items() if c}
        ok = nonzero == expected[mode]
        emit({"phase": "main_path", "program": "axpydot", "mode": mode,
              "launches": nonzero, "beta": float(out["beta"]), "ok": ok})
        check(ok, f"axpydot {mode}: launches {nonzero}")
    for mode in ("dataflow", "nodataflow"):
        err = abs(float(betas[mode]) - float(betas["reference"]))
        err64 = abs(float(betas[mode]) - exact)
        ok = err <= 1e-5 * mag and err64 <= 1e-5 * mag
        emit({"phase": "main_path_check", "mode": mode,
              "abs_err_vs_reference": err, "abs_err_vs_f64": err64,
              "tol": 1e-5 * mag, "ok": ok})
        check(ok, f"axpydot {mode} disagrees with reference")

    wide_spec = {"name": "wide", "routines": [
        {"blas": "waxpby", "name": "wx",
         "scalars": {"alpha": 0.5, "beta": 2.0},
         "inputs": {"x": "x", "y": "y"}, "connections": {"out": "sc.x"}},
        {"blas": "scal", "name": "sc", "scalars": {"alpha": {"input": "a"}},
         "connections": {"out": ["dd.x", "nn.x", "im.x"]},
         "outputs": {"out": "s"}},
        {"blas": "dot", "name": "dd", "inputs": {"y": "x"},
         "outputs": {"out": "d"}},
        {"blas": "nrm2", "name": "nn", "outputs": {"out": "r"}},
        {"blas": "iamax", "name": "im", "outputs": {"out": "idx"}},
    ]}
    wide_inputs = dict(x=x, y=y, a=torch.tensor(3.0, device=dev))
    wide = {m: Program.from_spec(wide_spec, mode=m, device="cuda")
            for m in ("dataflow", "reference")}
    check(len(wide["dataflow"].groups) == 1, "wide spec: one group")
    got, counts = counted_run(lambda: wide["dataflow"](**wide_inputs))
    want, _ = counted_run(lambda: wide["reference"](**wide_inputs))
    nonzero = {k: c for k, c in counts.items() if c}
    s64 = 3.0 * (0.5 * x.double() + 2.0 * y.double())
    s_err = float((got["s"] - want["s"]).abs().max())
    d_err = abs(float(got["d"]) - float(want["d"]))
    r_err = abs(float(got["r"]) - float(want["r"]))
    top = float(want["s"].abs().max())
    ok = (nonzero == {"group_kernel": 1}
          and s_err <= 1e-6 * float(s64.abs().max())
          and d_err <= 1e-5 * float((s64 * x.double()).abs().sum())
          and r_err <= 1e-5 * float(want["r"])
          and float(want["s"][int(got["idx"])].abs()) >= top * (1 - 1e-6))
    emit({"phase": "main_path", "program": "waxpby->scal->{dot,nrm2,iamax}",
          "mode": "dataflow", "launches": nonzero, "s_max_abs_err": s_err,
          "d_abs_err": d_err, "r_abs_err": r_err,
          "idx": int(got["idx"]), "idx_reference": int(want["idx"]),
          "ok": ok})
    check(ok, "wide group disagrees with reference mode")

    def entry_points():
        return [ops.axpy(1.7, x, y), ops.scal(-0.3, x),
                ops.waxpby(0.5, x, -1.25, y), ops.copy(x),
                ops.vmul(x, y), ops.rot(0.6, 0.8, x, y), ops.dot(x, y),
                ops.asum(x), ops.nrm2(x), ops.iamax(x),
                ops.axpydot(0.9, x, y, z), ops.axpydot_nodf(0.9, x, y, z)]

    _, counts = counted_run(entry_points)
    emit({"phase": "main_path", "program": "ops entry points",
          "launches": {k: c for k, c in counts.items() if c}})
    missing = [k for k, c in launches.items() if c == 0]
    check(not missing, f"kernels never launched on the main path: "
                       f"{missing}")

    # ------------------------------------------------------------------
    # 3. repeatability
    # ------------------------------------------------------------------
    b1 = prog(**axpydot_inputs)["beta"].clone()
    b2 = prog(**axpydot_inputs)["beta"].clone()
    n1 = programs["nodataflow"](**axpydot_inputs)["beta"].clone()
    n2 = programs["nodataflow"](**axpydot_inputs)["beta"].clone()
    ok = bool(torch.equal(b1, b2)) and bool(torch.equal(n1, n2))
    emit({"phase": "repeatability", "dataflow": [float(b1), float(b2)],
          "nodataflow": [float(n1), float(n2)], "bitwise_equal": ok})
    check(ok, "dataflow axpydot is not bitwise repeatable")

    # ------------------------------------------------------------------
    # 4. times
    # ------------------------------------------------------------------
    def cuda_ms(fn, reps=20, warm=3):
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

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    n4 = 4 * N
    gvecs = group_vecs(x, y, z)
    lib = torch
    table = {
        # name: (kernel fn, plain fn, library fn or None, bytes, flops,
        #        source, replaces)
        "axpy": (lambda: ops.axpy(1.7, x, y),
                 lambda: k_axpy.axpy_plain(1.7, x, y),
                 lambda: lib.add(y, x, alpha=1.7), 3 * n4, 2 * N,
                 "axpy.py", "kernels/axpy.py:58"),
        "scal": (lambda: ops.scal(-0.3, x),
                 lambda: k_axpy.scal_plain(-0.3, x),
                 lambda: lib.mul(x, -0.3), 2 * n4, N,
                 "axpy.py", "kernels/axpy.py:58"),
        "waxpby": (lambda: ops.waxpby(0.5, x, -1.25, y),
                   lambda: k_axpy.waxpby_plain(0.5, x, -1.25, y),
                   None, 3 * n4, 3 * N, "axpy.py", "kernels/axpy.py:58"),
        "copy": (lambda: ops.copy(x), lambda: k_axpy.copy_plain(x),
                 lambda: x.clone(), 2 * n4, 0,
                 "axpy.py", "kernels/axpy.py:58"),
        "vmul": (lambda: ops.vmul(x, y), lambda: k_axpy.vmul_plain(x, y),
                 lambda: lib.mul(x, y), 3 * n4, N,
                 "axpy.py", "kernels/axpy.py:58"),
        "rot": (lambda: ops.rot(0.6, 0.8, x, y),
                lambda: k_axpy.rot_plain(0.6, 0.8, x, y), None,
                4 * n4, 6 * N, "axpy.py", "kernels/axpy.py:58"),
        "dot": (lambda: ops.dot(x, y), lambda: k_dot.dot_plain(x, y),
                lambda: lib.dot(x, y), 2 * n4, 2 * N,
                "dot.py", "kernels/dot.py:108"),
        "asum": (lambda: ops.asum(x), lambda: k_dot.asum_plain(x),
                 lambda: lib.linalg.vector_norm(x, 1), n4, 2 * N,
                 "dot.py", "kernels/dot.py:108"),
        "nrm2": (lambda: ops.nrm2(x), lambda: k_dot.nrm2_plain(x),
                 lambda: lib.linalg.vector_norm(x), n4, 2 * N,
                 "dot.py", "kernels/dot.py:108"),
        "iamax": (lambda: ops.iamax(x), lambda: k_dot.iamax_plain(x),
                  lambda: lib.argmax(x.abs()), n4, 2 * N,
                  "dot.py", "kernels/dot.py:144"),
        "axpydot": (lambda: ops.axpydot(0.9, x, y, z),
                    lambda: k_axpydot.axpydot_plain(0.9, x, y, z), None,
                    3 * n4, 4 * N, "axpydot.py", "kernels/axpydot.py:54"),
        "group_kernel": (lambda: group_run(group_scalars, gvecs),
                         lambda: group_run.plain(group_scalars, gvecs),
                         None,
                         3 * n4, 4 * N, None, "core/codegen.py:363"),
    }
    kernels = []
    for name, (kfn, pfn, lfn, nbytes, flops, src, replaces) in \
            table.items():
        # plain, kernel, kernel, plain: compare only within one call
        p1 = cuda_ms(pfn)
        k1 = cuda_ms(kfn)
        k2 = cuda_ms(kfn)
        p2 = cuda_ms(pfn)
        lib_ms = cuda_ms(lfn) if lfn is not None else None
        b_ms, b_by = bound(nbytes, flops)
        entry = {
            "name": name, "route": "triton",
            "source": ("src/repro_torch/core/codegen.py" if src is None
                       else f"src/repro_torch/kernels/{src}"),
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name],
            "finish_launches": finishes[name],
            "max_abs_err": errors[name],
            "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}
        if name == "iamax":
            entry["library_note"] = "torch.argmax(x.abs()): two calls"
        kernels.append(entry)

    df1 = cuda_ms(lambda: programs["dataflow"](**axpydot_inputs))
    ndf1 = cuda_ms(lambda: programs["nodataflow"](**axpydot_inputs))
    ndf2 = cuda_ms(lambda: programs["nodataflow"](**axpydot_inputs))
    df2 = cuda_ms(lambda: programs["dataflow"](**axpydot_inputs))
    ref_ms = cuda_ms(lambda: programs["reference"](**axpydot_inputs))
    wide_ms = cuda_ms(lambda: wide["dataflow"](**wide_inputs))
    wide_run = codegen.make_group_callable(
        wide["dataflow"].graph, wide["dataflow"].groups[0], torch.float32)
    wide_scalars = {("wx", "alpha"): 0.5, ("wx", "beta"): 2.0,
                    ("sc", "alpha"): wide_inputs["a"]}
    wide_vecs = {("wx", "x"): x, ("wx", "y"): y, ("dd", "y"): x}
    check(set(wide_run.signature.vec_in_keys) == set(wide_vecs),
          "wide group signature")
    wide_kernel_ms = cuda_ms(lambda: wide_run(wide_scalars, wide_vecs))
    df, ndf = min(df1, df2), min(ndf1, ndf2)
    emit({"phase": "times", "program": "axpydot", "n": N,
          "dataflow_ms": df, "dataflow_runs": [df1, df2],
          "dataflow_bound_ms": 3 * n4 / HBM_BYTES_PER_S * 1e3,
          "nodataflow_ms": ndf, "nodataflow_runs": [ndf1, ndf2],
          "nodataflow_traffic_bound_ms": 5 * n4 / HBM_BYTES_PER_S * 1e3,
          "reference_ms": ref_ms, "nodf_over_df": ndf / df,
          "expected_ratio": 5 / 3})
    emit({"phase": "times", "program": "waxpby->scal->{dot,nrm2,iamax}",
          "n": N, "dataflow_ms": wide_ms, "group_kernel_ms": wide_kernel_ms,
          "bound_ms": 3 * n4 / HBM_BYTES_PER_S * 1e3})
    emit({"phase": "build", "first_call_s": first_call_s,
          "first_calls_total_s": sum(first_call_s.values())})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
