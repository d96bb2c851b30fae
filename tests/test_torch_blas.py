"""Port parity for the public API (`repro_torch/blas/`) against the
reference's `repro.blas`, on the CPU: the registry-generated routine
functions, `routine_spec`, `api_table` and the CLI, `compile` ->
`Executable` over both program kinds (run, one, batched, describe,
cost_report, save/load), the solver functions, and the fluent
`ProgramBuilder` with its lossless round trips. Mirrors
tests/test_blas_api.py and tests/test_builder.py; the same seeded numpy
operands go through both packages.

Tolerances: a routine's result within rtol 1e-5 and atol 1e-5 of
max(1, |reference|max) (float32, sums in another order), an index
exactly; a solve's iterations and status exactly and x within rtol 1e-5
and atol 1e-6 of max(1, |x|max); digests, spec dicts, saved files, CLI
output and cost-model counts exactly. Where both sides of a comparison
are the port running the same compiled program, bitwise.

Calls into the reference's `blas.compile` on a dataflow spec pass
`tiles="default"`, and every test runs with the reference's tuning
store pointed at a temporary directory, so no port test writes the
store that tests/test_tune.py and tests/test_compile_once.py read.
"""
import inspect
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jblas
from repro.blas.__main__ import main as jmain
from repro.core import lowering as jlowering, runtime as jruntime
from repro.solvers import specs as jspecs
from repro.tune import store as jstore
from repro_torch import blas
from repro_torch.blas import executable as t_exe, functional
from repro_torch.blas.__main__ import main as tmain
from repro_torch.core import lowering, routines as R, runtime
from repro_torch.core import spec as spec_mod
from repro_torch.core.runtime import Results, inputs_from_numpy
from repro_torch.solvers import CG, BiCGStab, Jacobi, PowerIteration, specs
from repro_torch.solvers.driver import SolverResult
from repro_torch.tune import config as tconfig, store as tstore

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
CPU = "cpu"


@pytest.fixture(autouse=True)
def private_tuning_store(monkeypatch, tmp_path):
    """Both packages' tuning stores live in temporary directories for
    the test and are re-read from the real environment after it."""
    monkeypatch.setenv(jstore.ENV_CACHE_DIR, str(tmp_path / "tune"))
    monkeypatch.setenv(tstore.ENV_CACHE_DIR, str(tmp_path / "tune_torch"))
    jstore.reset_store()
    tstore.reset_store()
    yield
    monkeypatch.undo()
    jstore.reset_store()
    tstore.reset_store()


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(n, seed=0):
    m = _rng(seed).standard_normal((n, n))
    return (m @ m.T / n + np.eye(n)).astype(np.float32)


def _nonsym(n, seed=3):
    a = _rng(seed).standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    return a.astype(np.float32)


def _diag_dominant(n, seed=0):
    a = _spd(n, seed)
    return (a + 2.0 * np.diag(np.abs(a).sum(axis=1))).astype(np.float32)


def _rhs(n, seed=1):
    return _rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-5,
        atol=1e-5 * max(1.0, float(np.abs(want).max(initial=0.0))))


# ---------------------------------------------------------------------------
# Function layer
# ---------------------------------------------------------------------------

N, M, S = 96, 40, 3


def _routine_args(name):
    """Seeded numpy arguments of blas.<name>, in signature order."""
    rng = _rng(sum(map(ord, name)))
    vec = lambda n: rng.standard_normal(n).astype(np.float32)  # noqa: E731
    mat = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    scalars = [np.float32(v) for v in (1.3, -0.7)]
    rdef = R.get(name)
    args = scalars[:len(rdef.scalars)]
    if name in ("gemv",):
        return args + [mat(M, N), vec(N), vec(M)]
    if name == "gemvt":
        return args + [mat(M, N), vec(M), vec(N)]
    if name == "symv":
        a = mat(N, N)
        return args + [(a + a.T) / 2, vec(N), vec(N)]
    if name == "gemm":
        return args + [mat(M, 24), mat(24, N), mat(M, N)]
    if name == "ger":
        return args + [vec(M), vec(N), mat(M, N)]
    if name == "transpose":
        return [mat(M, N)]
    if name == "colaxpy":
        return [vec(S), mat(N, S), mat(N, S)]
    if name == "coldot":
        return [mat(N, S), mat(N, S)]
    if name == "vdiv":
        return [vec(N), np.abs(vec(N)) + 0.5]
    return args + [vec(N) for _ in rdef.inputs]


def _port_call(name, args, **kw):
    return getattr(blas, name)(*[_t(a) if isinstance(a, np.ndarray)
                                 and a.ndim else float(a) for a in args],
                               device=CPU, **kw)


def _ref_call(name, args, **kw):
    return getattr(jblas, name)(*[jnp.asarray(a) for a in args], **kw)


def test_every_registry_routine_is_a_blas_callable():
    for name in R.names():
        assert callable(getattr(blas, name)), name
        assert name in blas.__all__
    assert blas.routines() == list(R.names())
    # the reference's API, the escalation ladder's two types included
    assert sorted(blas.__all__) == sorted(jblas.__all__)
    import repro_torch
    assert repro_torch.blas is blas


@pytest.mark.parametrize("name", sorted(R.names()))
def test_routine_signature_matches_reference(name):
    got = inspect.signature(getattr(blas, name))
    want = inspect.signature(getattr(jblas, name))
    swap = {"interpret": "device"}
    assert list(got.parameters) == [swap.get(p, p) for p in want.parameters]
    for p, q in zip(got.parameters.values(), want.parameters.values()):
        assert (p.kind, p.default) == (q.kind, q.default)
    assert getattr(blas, name).__qualname__ == f"blas.{name}"


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow", "reference"])
@pytest.mark.parametrize("name", sorted(R.names()))
def test_routine_matches_reference(name, mode):
    args = _routine_args(name)
    got = _port_call(name, args, mode=mode)
    want = _ref_call(name, args, mode=mode)
    if name == "rot":
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            _close(g, w)
    elif name == "iamax":
        assert int(got) == int(want)
    else:
        _close(got, want)


def test_function_layer_matches_plain_program():
    """blas.<name> is the single-routine program: the same bits as
    Program.from_spec(routine_spec(name)) on the same inputs."""
    args = _routine_args("gemv")
    got = _port_call("gemv", args)
    prog = runtime.Program.from_spec(functional.routine_spec("gemv"),
                                     device=CPU)
    want = prog(alpha=float(args[0]), beta=float(args[1]), A=_t(args[2]),
                x=_t(args[3]), y=_t(args[4]))["out"]
    assert torch.equal(got, want)


def test_multi_output_routine_returns_port_ordered_tuple():
    x, y = torch.arange(8.0), torch.ones(8)
    out_x, out_y = blas.rot(0.6, 0.8, x, y, device=CPU)
    np.testing.assert_allclose(out_x, 0.6 * x + 0.8 * y, rtol=1e-6)
    np.testing.assert_allclose(out_y, 0.6 * y - 0.8 * x, rtol=1e-6)


def test_function_layer_compiles_once_per_configuration():
    x, y = torch.arange(16.0), torch.ones(16)
    blas.asum(x, device=CPU)                 # warm the memos
    blas.axpy(2.0, x, y, device=CPU)
    before = lowering.cache_stats()
    for _ in range(5):
        blas.asum(x, device=CPU)
        blas.axpy(2.0, x, y, device=CPU)
    after = lowering.cache_stats()
    # repeated calls never consult the digest cache, let alone miss it
    assert after == before
    assert list(blas.axpy._compiled) == [("dataflow", CPU, "float32")]


def test_function_layer_keyword_args_modes_and_dtype():
    x, y = torch.arange(32.0), torch.ones(32)
    df = blas.waxpby(alpha=2.0, beta=3.0, x=x, y=y, device=CPU)
    nodf = blas.waxpby(2.0, 3.0, x, y, mode="nodataflow", device=CPU)
    ref_ = blas.waxpby(2.0, 3.0, x, y, mode="reference", device=CPU)
    np.testing.assert_allclose(df, nodf, rtol=1e-6)
    np.testing.assert_allclose(df, ref_, rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported dtype"):
        blas.dot(x, y, dtype="float64", device=CPU)


def test_function_layer_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blas.dot(torch.ones(4), torch.ones(4))


@pytest.mark.parametrize("name", sorted(R.names()))
def test_routine_spec_matches_reference(name):
    from repro.blas.functional import routine_spec as jroutine_spec
    for dtype in ("float32", "bfloat16"):
        assert functional.routine_spec(name, dtype) == \
            jroutine_spec(name, dtype)


def test_api_table_matches_reference():
    assert blas.api_table() == jblas.api_table()


@pytest.mark.parametrize("argv", [["--list"], ["--spec", "dot"],
                                  ["--spec", "gemv"], ["--spec", "nosuch"],
                                  []])
def test_cli_output_matches_reference(argv, capsys):
    rc = tmain(argv)
    got = capsys.readouterr()
    want_rc = jmain(argv)
    want = capsys.readouterr()
    assert rc == want_rc
    assert got.out.replace("repro_torch.blas", "repro.blas") == want.out
    assert got.err == want.err


def test_cli_spec_roundtrips_through_compile(capsys):
    assert tmain(["--spec", "dot"]) == 0
    raw = json.loads(capsys.readouterr().out)
    exe = blas.compile(raw, device=CPU)
    x = torch.arange(16.0)
    np.testing.assert_allclose(exe.one(x=x, y=x), float((x * x).sum()),
                               rtol=1e-5)


def test_cli_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.blas", "--list"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == jblas.api_table()


# ---------------------------------------------------------------------------
# compile() -> Executable, both kinds
# ---------------------------------------------------------------------------


def _axpydot_inputs(n=256):
    rng = _rng(0)
    return {"neg_alpha": np.float32(-0.7),
            **{k: rng.standard_normal(n).astype(np.float32)
               for k in ("w", "v", "u")}}


def test_compile_dataflow_spec_runs_and_unwraps():
    exe = blas.compile(runtime.AXPYDOT_SPEC, device=CPU)
    assert exe.kind == "dataflow" and exe.device == torch.device(CPU)
    ops = _axpydot_inputs()
    out = exe.run(**inputs_from_numpy(ops, device=CPU))
    assert isinstance(out, Results)
    assert torch.equal(out.one(), out["beta"])
    jexe = jblas.compile(jruntime.AXPYDOT_SPEC, tiles="default")
    _close(exe.one(**inputs_from_numpy(ops, device=CPU)),
           jexe.one(**{k: jnp.asarray(v) for k, v in ops.items()}))
    assert "FUSED" in exe.describe()
    assert exe.input_names == jexe.input_names
    assert exe.output_names == jexe.output_names


def test_compile_loop_spec_runs_and_matches_reference():
    n = 96
    A, b = _spd(n), _rhs(n)
    ops = {"A": A, "b": b, "x0": np.zeros(n, np.float32)}
    exe = blas.compile(specs.CG_LOOP, max_iters=300, device=CPU)
    assert exe.kind == "loop"
    res = exe.run(tol=1e-6, **inputs_from_numpy(ops, device=CPU))
    assert isinstance(res, SolverResult)
    assert bool(res.converged)
    jres = jblas.compile(jspecs.CG_LOOP, max_iters=300).run(
        tol=1e-6, **{k: jnp.asarray(v) for k, v in ops.items()})
    assert int(res.iterations) == int(jres.iterations)
    assert res.status_names() == jres.status_names()
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(exe.one(**inputs_from_numpy(ops, device=CPU)),
                       res.x)
    assert exe.input_names == ["A", "b", "x0"]
    assert exe.output_names == ["x"]
    assert exe.trace_count == 1


def test_compile_accepts_json_string_path_and_shares_the_cache(tmp_path):
    exe1 = blas.compile(runtime.AXPY_SPEC, device=CPU)
    exe2 = blas.compile(json.dumps(runtime.AXPY_SPEC), device=CPU)
    path = tmp_path / "axpy.json"
    path.write_text(json.dumps(runtime.AXPY_SPEC))
    exe3 = blas.compile(path, device=CPU)
    assert exe1._impl.ir is exe2._impl.ir is exe3._impl.ir
    exe4 = blas.compile(spec_mod.parse(runtime.AXPY_SPEC), device=CPU)
    assert exe4.output_names == exe1.output_names
    with pytest.raises(spec_mod.SpecError, match="compile\\(\\) needs"):
        blas.compile(42, device=CPU)


def test_one_raises_on_multi_output_program():
    exe = blas.compile(specs.CG_MATVEC, device=CPU)
    with pytest.raises(ValueError, match="single-output"):
        exe.run(A=_t(_spd(32)), p=_t(_rhs(32))).one()


def test_results_one_on_plain_program_call():
    prog = runtime.Program.from_spec(specs.NRM2, device=CPU)
    out = prog(x=torch.arange(64.0))
    assert isinstance(out, Results)
    assert torch.equal(out.one(), out["norm"])


_BATCHED = {
    "AXPY_SPEC": ({"alpha": np.float32(0.5),
                   "x": np.arange(24.0, dtype=np.float32).reshape(4, 6),
                   "y": np.ones((4, 6), np.float32)}, {"alpha": None}),
    "AXPYDOT_SPEC": ({"neg_alpha": np.float32(-0.7),
                      **{k: _rng(i).standard_normal((3, 32)).astype(
                          np.float32) for i, k in enumerate("wvu")}},
                     None),
    "GEMV_SPEC": ({"alpha": np.float32(1.5), "beta": np.float32(0.5),
                   "A": _rng(4).standard_normal((20, 16)).astype(
                       np.float32),
                   "x": _rng(5).standard_normal((5, 16)).astype(np.float32),
                   "y": _rng(6).standard_normal((5, 20)).astype(
                       np.float32)}, None),
}


@pytest.mark.parametrize("name", sorted(_BATCHED))
def test_executable_batched_dataflow_matches_reference_vmap(name):
    ops, axes = _BATCHED[name]
    exe = blas.compile(getattr(runtime, name), device=CPU)
    got = exe.batched(axes=axes, **{k: _t(v) if v.ndim else float(v)
                                    for k, v in ops.items()})
    jexe = jblas.compile(getattr(jruntime, name), tiles="default")
    want = jexe.batched(axes=axes, **{k: jnp.asarray(v)
                                      for k, v in ops.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    # lane i is the program's own run on lane i's inputs, bitwise
    lane = {k: _t(v[1]) if k in ("x", "y", "w", "v", "u") else
            (_t(v) if v.ndim else float(v)) for k, v in ops.items()}
    for k, v in exe.run(**lane).items():
        assert torch.equal(got[k][1], v)


def test_executable_batched_dataflow_checks_its_inputs():
    exe = blas.compile(runtime.AXPY_SPEC, device=CPU)
    x = torch.arange(24.0).reshape(4, 6)
    with pytest.raises(ValueError, match="unknown inputs"):
        exe.batched(alpha=0.5, x=x, y=x, nope=x)
    with pytest.raises(ValueError, match="axes for unknown"):
        exe.batched(alpha=0.5, x=x, y=x, axes={"nope": 0})
    with pytest.raises(ValueError, match="batch size"):
        exe.batched(alpha=0.5, x=x, y=x[:2])
    with pytest.raises(TypeError, match="loop-program knob"):
        exe.batched(alpha=0.5, x=x, y=x, tol=1e-3)


def test_executable_batched_loop_raises_naming_item_17():
    exe = blas.compile(specs.CG_LOOP, max_iters=30, device=CPU)
    B = torch.zeros(3, 16)
    with pytest.raises(NotImplementedError, match="item 17"):
        exe.batched(A=torch.eye(16), b=B, x0=B, tol=1e-6)


@pytest.mark.parametrize("name", ["AXPYDOT_SPEC", "CG_LOOP",
                                  "BICGSTAB_LOOP", "GMRES_LOOP",
                                  "BLOCK_CG_LOOP", "RESIDUAL"])
def test_save_is_byte_equal_to_reference(name, tmp_path):
    raw = getattr(runtime, name, None) or getattr(specs, name)
    jraw = getattr(jruntime, name, None) or getattr(jspecs, name)
    loop = spec_mod.is_loop_spec(raw)
    kw = {"max_iters": 5} if loop else {}
    got = blas.compile(raw, device=CPU, **kw).save(tmp_path / "port.json")
    want = jblas.compile(jraw, **(kw or {"tiles": "default"})).save(
        tmp_path / "ref.json")
    assert got.read_bytes() == want.read_bytes()


def test_save_load_roundtrip(tmp_path):
    n = 64
    A, b = _t(_spd(n)), _t(_rhs(n))
    exe = blas.compile(specs.CG_LOOP, max_iters=300, device=CPU)
    path = exe.save(tmp_path / "cg.json")
    exe2 = blas.load(path, max_iters=300, device=CPU)
    r1 = exe.run(A=A, b=b, x0=torch.zeros_like(b))
    r2 = exe2.run(A=A, b=b, x0=torch.zeros_like(b))
    assert int(r1.iterations) == int(r2.iterations)
    assert torch.equal(r1.x, r2.x)
    # the saved artifact is a plain spec: LoopProgram reads it
    from repro_torch.solvers import LoopProgram
    lp = LoopProgram(json.loads(path.read_text()), max_iters=300,
                     device=CPU)
    assert int(lp.solve(A=A, b=b, x0=torch.zeros_like(b)).iterations) == \
        int(r1.iterations)


def test_save_preserves_let_binding_order(tmp_path):
    exe = blas.compile(specs.CG_LOOP, max_iters=5, device=CPU)
    raw = json.loads(exe.save(tmp_path / "cg.json").read_text())
    lets = [s["let"] for s in raw["iterate"]["body"] if "let" in s]
    assert list(lets[0]) == ["alpha", "neg_alpha"]
    assert list(lets[1]) == ["rz_next", "beta"]


_COSTS = {
    "AXPYDOT_SPEC": {"v": 4096, "w": 4096, "u": 4096},
    "RESIDUAL": {"A": (512, 512), "x": 512, "b": 512},
    "BLOCK_CG_MATVEC": {"A": (256, 256), "P": (256, 8)},
    "CG_LOOP": {"A": (1024, 1024), "b": 1024, "x0": 1024},
    "BICGSTAB_LOOP": {"A": (512, 512), "b": 512, "x0": 512},
    "JACOBI_LOOP": {"A": (512, 512), "b": 512, "x0": 512, "dinv": 512},
    "GMRES_LOOP": {"A": (512, 512), "b": 512, "x0": 512},
    "BLOCK_CG_LOOP": {"A": (256, 256), "B": (256, 8), "x0": (256, 8)},
}


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
@pytest.mark.parametrize("name", sorted(_COSTS))
def test_cost_report_matches_reference(name, mode):
    raw = getattr(runtime, name, None) or getattr(specs, name)
    jraw = getattr(jruntime, name, None) or getattr(jspecs, name)
    kw = {"max_iters": 5} if spec_mod.is_loop_spec(raw) else \
        {"tiles": "default"}
    got = blas.compile(raw, mode=mode, device=CPU,
                       **{k: v for k, v in kw.items() if k != "tiles"}
                       ).cost_report(_COSTS[name])
    want = jblas.compile(jraw, mode=mode, **kw).cost_report(_COSTS[name])
    for field in ("program", "mode", "kind", "rows", "flops", "bytes_naive",
                  "fused_savings", "fused_savings_exact", "matrix_bytes",
                  "bytes", "vector_bytes", "bytes_exact"):
        assert getattr(got, field) == getattr(want, field), field
    # times from the card's rates, not the reference's
    assert got.t_compute == got.flops / 67e12
    assert got.t_memory == got.bytes / 3.35e12
    assert got.bound == ("compute" if got.t_compute >= got.t_memory
                         else "memory")
    assert "kept on-chip by fusion" in str(got)


def test_cost_report_needs_every_shape():
    exe = blas.compile(specs.CG_LOOP, max_iters=5, device=CPU)
    with pytest.raises(ValueError, match="missing shape"):
        exe.cost_report({"A": (64, 64)})
    dexe = blas.compile(runtime.AXPYDOT_SPEC, device=CPU)
    with pytest.raises(ValueError, match="missing shape"):
        dexe.cost_report({"v": 64})


def test_executable_spec_is_isolated_from_caller_mutation(tmp_path):
    spec = json.loads(json.dumps(runtime.AXPY_SPEC))
    exe = blas.compile(spec, device=CPU)
    spec["routines"][0]["scalars"]["alpha"] = {"value": 99.0}
    assert exe.spec["routines"][0]["scalars"]["alpha"] == {"input": "alpha"}
    saved = json.loads(exe.save(tmp_path / "axpy.json").read_text())
    assert saved["routines"][0]["scalars"]["alpha"] == {"input": "alpha"}
    assert exe.builder().to_spec() == exe.spec


def test_compile_rejects_mismatched_knobs():
    with pytest.raises(ValueError, match="loop program"):
        blas.compile(runtime.AXPY_SPEC, max_iters=5, device=CPU)
    with pytest.raises(ValueError, match="fuse"):
        blas.compile(specs.CG_LOOP, fuse=True, device=CPU)
    with pytest.raises(TypeError, match="loop-program knob"):
        blas.compile(runtime.AXPY_SPEC, device=CPU).run(tol=1.0)


@pytest.mark.parametrize("case", ["profile", "tune", "tiles", "verify"])
def test_ported_layers_match_the_reference(case):
    """`Executable.profile`, `Executable.tune`, explicit tile configs and
    `Executable.verify` (once refusals naming ROADMAP items 11 and 12)
    against the reference's, on the CPU."""
    exe = blas.compile(runtime.AXPY_SPEC, device=CPU)
    jexe = jblas.compile(jruntime.AXPY_SPEC, tiles="default")
    shapes = {"x": 64, "y": 64}
    if case == "profile":
        got, want = exe.profile(shapes, iters=1), jexe.profile(shapes,
                                                               iters=1)
        assert [(r.label, r.routines, r.modeled_bytes, r.modeled_flops)
                for r in got.rows] == [
            (r.label, r.routines, r.modeled_bytes, r.modeled_flops)
            for r in want.rows]
        assert all(r.measured_s > 0 for r in got.rows)
    elif case == "tune":
        tuned = exe.tune(shapes, budget=2, iters=1)
        assert tuned is not exe and tuned.tune_report.sweeps <= 2
        x, y = (torch.from_numpy(_rng(s).standard_normal(64).astype(
            np.float32)) for s in (1, 2))
        torch.testing.assert_close(tuned.run(x=x, y=y, alpha=2.0).one(),
                                   exe.run(x=x, y=y, alpha=2.0).one())
    elif case == "tiles":
        cfg = tconfig.TileConfig(block_rows=1024)
        one = blas.compile(runtime.AXPY_SPEC, device=CPU, tiles=cfg)
        assert one._impl.ir.tile_plan == tconfig.TilePlan.everywhere(cfg)
        assert one._impl.ir is not exe._impl.ir
        loop = blas.compile(specs.CG_LOOP, device=CPU, tiles=cfg)
        plans = {cs.ir.tile_plan for cs in loop._impl.lir.body
                 if cs.tag == "program"}
        assert plans == {tconfig.TilePlan.everywhere(cfg)}
    else:
        report = exe.verify()
        assert report.to_dict() == jexe.verify().to_dict()
        # compile(verify=False) lowers the same program (one cache entry)
        assert blas.compile(runtime.AXPY_SPEC, device=CPU,
                            verify=False)._impl.ir is exe._impl.ir


@pytest.mark.parametrize("case", ["fault", "solve"])
def test_guard_layer_is_ported(case):
    """What raised naming ROADMAP Queue 1, item 10 until the guard layer
    was ported: `compile(fault=)` arms the plan on the programs it
    matches, outside the program cache, as the reference's does; and
    `blas.solve` runs the escalation ladder, with the reference's
    attempt log."""
    from repro.guard import chaos as jchaos
    from repro_torch.guard import chaos

    x = _rng(3).standard_normal(64).astype(np.float32)
    y = _rng(4).standard_normal(64).astype(np.float32)
    if case == "fault":
        clean = blas.compile(runtime.AXPY_SPEC, device=CPU)
        before = lowering.cache_stats()
        exe = blas.compile(runtime.AXPY_SPEC, device=CPU,
                           fault=chaos.FaultPlan(program="*", kind="scale",
                                                 factor=-2.0))
        assert lowering.cache_stats() == before    # nothing cached
        assert exe._impl.ir is not clean._impl.ir
        jexe = jblas.compile(jruntime.AXPY_SPEC, tiles="default",
                             fault=jchaos.FaultPlan(program="*",
                                                    kind="scale",
                                                    factor=-2.0))
        got = exe.one(alpha=0.5, x=torch.from_numpy(x),
                      y=torch.from_numpy(y))
        want = np.asarray(jexe.one(alpha=jnp.float32(0.5),
                                   x=jnp.asarray(x), y=jnp.asarray(y)))
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-5,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    else:
        a = _spd(24, seed=2)
        b = _rng(5).standard_normal(24).astype(np.float32)
        res = blas.solve(torch.from_numpy(a), torch.from_numpy(b),
                         device=CPU)
        jres = jblas.solve(jnp.asarray(a), jnp.asarray(b))
        assert res.status_names() == "CONVERGED"
        assert [(t.solver, t.action, t.status_name)
                for t in res.attempts] == \
            [(t.solver, t.action, t.status_name) for t in jres.attempts]
        want = np.asarray(jres.x)
        np.testing.assert_allclose(
            res.x.numpy(), want, rtol=1e-5,
            atol=1e-6 * max(1.0, float(np.abs(want).max())))


def test_tiles_auto_means_kernel_defaults():
    auto = blas.compile(runtime.AXPY_SPEC, device=CPU)
    default = blas.compile(runtime.AXPY_SPEC, device=CPU, tiles="default")
    assert auto.tiles == "auto" and default.tiles == "default"
    assert auto._impl.ir is default._impl.ir


# ---------------------------------------------------------------------------
# Wrapped class solvers
# ---------------------------------------------------------------------------


def test_executable_from_solver():
    exe = t_exe.Executable.from_solver(PowerIteration(max_iters=50,
                                                      device=CPU))
    assert exe.kind == "loop" and exe.spec is None
    assert exe.input_names is None and exe.output_names == ["x"]
    assert exe.trace_count == 0
    for call in (exe.builder, lambda: exe.save("x.json"), exe.verify):
        with pytest.raises(ValueError, match="class-based solver"):
            call()
    with pytest.raises(TypeError, match="class-based"):
        exe.cost_report({"A": (8, 8)})
    with pytest.raises(TypeError, match="solve_batched"):
        exe.batched(A=torch.eye(8))
    res = exe.run(A=_t(_spd(32)), tol=1e-4)
    assert exe.trace_count == 1 and bool(res.converged)
    assert "solver 'power'" in exe.describe()


# ---------------------------------------------------------------------------
# Solver functions on the unified path
# ---------------------------------------------------------------------------


def _solver_case(name):
    n = 96
    if name == "jacobi":
        return _diag_dominant(n), _rhs(n)
    if name in ("bicgstab", "gmres"):
        return _nonsym(n), _rhs(n)
    return _spd(n), _rhs(n)


def _assert_same_result(got, want):
    assert int(got.iterations) == int(want.iterations)
    assert got.status_names() == want.status_names()
    wx = np.asarray(want.x.numpy() if torch.is_tensor(want.x) else want.x)
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(wx).max())))


@pytest.mark.parametrize("name", ["cg", "bicgstab", "jacobi", "gmres"])
def test_blas_solver_matches_reference(name):
    A, b = _solver_case(name)
    got = getattr(blas, name)(_t(A), _t(b), tol=1e-6, device=CPU)
    want = getattr(jblas, name)(jnp.asarray(A), jnp.asarray(b), tol=1e-6)
    assert got.status_names() == "CONVERGED"
    _assert_same_result(got, want)


@pytest.mark.parametrize("name,cls", [("cg", CG), ("bicgstab", BiCGStab),
                                      ("jacobi", Jacobi)])
def test_blas_solver_matches_class_solver_bitwise(name, cls):
    A, b = _solver_case(name)
    got = getattr(blas, name)(_t(A), _t(b), tol=1e-7, max_iters=300,
                              device=CPU)
    want = cls(max_iters=300, device=CPU).solve(_t(A), _t(b), tol=1e-7)
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


def test_blas_jacobi_richardson_and_omega_match_reference():
    A, b = _spd(64), _rhs(64)
    got = blas.jacobi(_t(A), _t(b), omega=0.3, richardson=True,
                      max_iters=300, device=CPU)
    want = jblas.jacobi(jnp.asarray(A), jnp.asarray(b), omega=0.3,
                        richardson=True, max_iters=300)
    assert got.status_names() == "CONVERGED"
    _assert_same_result(got, want)


def test_blas_block_cg_matches_reference_and_columns():
    n, s = 64, 3
    A = _spd(n)
    B = _rng(7).standard_normal((n, s)).astype(np.float32)
    got = blas.block_cg(_t(A), _t(B), tol=1e-6, device=CPU)
    want = jblas.block_cg(jnp.asarray(A), jnp.asarray(B), tol=1e-6)
    assert got.status_names() == "CONVERGED"
    _assert_same_result(got, want)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, B),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match=r"\(n, s\) panel"):
        blas.block_cg(_t(A), _t(B[:, 0]), device=CPU)


def test_blas_gmres_restart_argument():
    A, b = _nonsym(64), _rhs(64)
    got = blas.gmres(_t(A), _t(b), restart=5, tol=1e-6, device=CPU)
    want = jblas.gmres(jnp.asarray(A), jnp.asarray(b), restart=5, tol=1e-6)
    _assert_same_result(got, want)
    with pytest.raises(ValueError, match="restart must be >= 1"):
        blas.gmres(_t(A), _t(b), restart=0, device=CPU)


def test_blas_power_iteration_matches_class_and_reference():
    A = _spd(96)
    got = blas.power_iteration(_t(A), tol=1e-9, max_iters=2000, device=CPU)
    want = PowerIteration(max_iters=2000, device=CPU).solve(_t(A), tol=1e-9)
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)
    jwant = jblas.power_iteration(jnp.asarray(A), tol=1e-9, max_iters=2000)
    np.testing.assert_allclose(float(got.aux["eigenvalue"]),
                               float(jwant.aux["eigenvalue"]), rtol=1e-4)
    np.testing.assert_allclose(float(got.aux["eigenvalue"]),
                               np.linalg.eigvalsh(A)[-1], rtol=1e-4)


def test_solver_executables_are_memoized():
    from repro_torch.blas import solvers as bs
    A, b = _t(_spd(48)), _t(_rhs(48))
    blas.cg(A, b, max_iters=200, device=CPU)
    size = len(bs._EXECUTABLES)
    blas.cg(A, b, max_iters=200, device=CPU)
    assert len(bs._EXECUTABLES) == size == 1
    blas.power_iteration(A, max_iters=200, device=CPU)
    blas.power_iteration(A, max_iters=200, device=CPU)
    assert len(bs._EXECUTABLES) == 2


def test_old_entrypoints_still_work():
    n = 64
    A, b = _t(_spd(n)), _t(_rhs(n))
    prog = runtime.Program.from_spec(runtime.AXPY_SPEC, device=CPU)
    assert prog(alpha=1.0, x=b, y=b)["out"].shape == (n,)
    from repro_torch.solvers import LoopProgram, cg
    assert bool(cg(A, b, tol=1e-6, max_iters=300, device=CPU).converged)
    lp = LoopProgram(specs.CG_LOOP, max_iters=300, device=CPU)
    assert bool(lp.solve(A=A, b=b, x0=torch.zeros_like(b)).converged)


# ---------------------------------------------------------------------------
# ProgramBuilder: round trips (tests/test_builder.py)
# ---------------------------------------------------------------------------

SHIPPED = {
    "AXPYDOT_SPEC": runtime.AXPYDOT_SPEC,
    "AXPY_SPEC": runtime.AXPY_SPEC,
    "GEMV_SPEC": runtime.GEMV_SPEC,
}
SHIPPED.update({n: getattr(specs, n) for n in dir(specs)
                if n.isupper() and isinstance(getattr(specs, n), dict)})


def _reference_spec(name):
    return getattr(jruntime, name, None) or getattr(jspecs, name)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_roundtrip_digest_equals_reference(name):
    raw = SHIPPED[name]
    once = blas.ProgramBuilder.from_spec(raw).to_spec()
    twice = blas.ProgramBuilder.from_spec(once).to_spec()
    want = jlowering.spec_digest(_reference_spec(name))
    assert lowering.spec_digest(once) == want
    assert lowering.spec_digest(twice) == want
    assert blas.ProgramBuilder.from_spec(raw).digest() == want
    assert jblas.ProgramBuilder.from_spec(
        _reference_spec(name)).to_spec() == once


def test_roundtrip_does_not_alias_the_original():
    b = blas.ProgramBuilder.from_spec(specs.CG_UPDATE)
    rt = b.to_spec()
    rt["routines"][0]["name"] = "mutated"
    assert specs.CG_UPDATE["routines"][0]["name"] == "xup"
    assert b.to_spec()["routines"][0]["name"] == "xup"


def test_unparse_reparse_fixpoint():
    for raw in (runtime.AXPYDOT_SPEC, specs.BICG_XRUPDATE, specs.RESIDUAL):
        canon = spec_mod.unparse(spec_mod.parse(raw))
        assert spec_mod.unparse(spec_mod.parse(canon)) == canon
    for raw in (specs.CG_LOOP, specs.JACOBI_LOOP, specs.BICGSTAB_LOOP,
                specs.GMRES_LOOP):
        canon = spec_mod.unparse_loop(spec_mod.parse_loop(raw))
        assert spec_mod.unparse_loop(spec_mod.parse_loop(canon)) == canon


def test_from_spec_accepts_parsed_specs_json_and_paths(tmp_path):
    b = blas.ProgramBuilder.from_spec(spec_mod.parse(specs.CG_MATVEC))
    exe = blas.compile(b, device=CPU)
    assert sorted(exe.output_names) == ["pq", "q"]
    bl = blas.ProgramBuilder.from_spec(spec_mod.parse_loop(specs.CG_LOOP))
    assert bl.is_loop
    assert spec_mod.is_loop_spec(bl.to_spec())
    path = tmp_path / "res.json"
    path.write_text(json.dumps(specs.RESIDUAL))
    for src in (json.dumps(specs.RESIDUAL), path,
                blas.ProgramBuilder.from_spec(specs.RESIDUAL)):
        assert blas.ProgramBuilder.from_spec(src).digest() == \
            lowering.spec_digest(specs.RESIDUAL)
    with pytest.raises(blas.BuilderError, match="from_spec needs"):
        blas.ProgramBuilder.from_spec(42)


def test_builder_digest_matches_lowering_digest():
    b = blas.ProgramBuilder.from_spec(specs.RESIDUAL)
    assert b.digest() == lowering.spec_digest(specs.RESIDUAL)
    # the lowering layer accepts the builder itself (to_spec protocol)
    assert lowering.spec_digest(b) == b.digest()
    ir = lowering.compile_cached(b, device=CPU)
    assert ir is lowering.compile_cached(specs.RESIDUAL, device=CPU)


def test_roundtrip_preserves_unknown_toplevel_keys():
    raw = {"name": "annotated", "comment": "kept verbatim",
           "routines": [{"blas": "dot", "name": "d0"}]}
    rt = blas.ProgramBuilder.from_spec(raw).to_spec()
    assert rt["comment"] == "kept verbatim"
    assert lowering.spec_digest(rt) == jlowering.spec_digest(raw)


# ---------------------------------------------------------------------------
# ProgramBuilder: fluent construction
# ---------------------------------------------------------------------------


def test_fluent_axpydot_matches_canned_program():
    b = blas.program("axpydot", dtype="float32")
    z = b.axpy(name="zcalc", alpha=b.input("neg_alpha"), x="v", y="w")
    b.dot(name="zdot", x=z, y="u", out="beta")
    assert b.digest() == lowering.spec_digest(runtime.AXPYDOT_SPEC)
    exe = blas.compile(b, device=CPU)
    ops = inputs_from_numpy(_axpydot_inputs(512), device=CPU)
    got = exe.one(**ops)
    want = runtime.axpydot_program(device=CPU)(**ops)["beta"]
    assert torch.equal(got, want)
    assert [g.nodes for g in exe._impl.groups] == [["zcalc", "zdot"]]


def test_fluent_fanout_builds_connection_list():
    b = blas.program("fan")
    t = b.gemv(name="mv", alpha=1.0, beta=0.0, A="A", x="s", y="s")
    b.dot(name="tt", x=t, y=t)
    b.dot(name="ts", x=t, y="s")
    raw = b.to_spec()
    assert raw["routines"][0]["connections"]["out"] == ["tt.x", "tt.y",
                                                        "ts.x"]
    exe = blas.compile(b, device=CPU)
    # mv.out is consumed on-chip and unaliased, so it is not public
    assert sorted(exe.output_names) == ["ts.out", "tt.out"]


def test_fluent_scalar_literal_and_multi_output():
    b = blas.program("rots")
    outs = b.rot(c=0.6, s=0.8, x="x", y="y",
                 out={"out_x": "xr", "out_y": "yr"})
    assert sorted(outs) == ["out_x", "out_y"]
    x, y = torch.arange(8.0), torch.ones(8)
    res = blas.compile(b, device=CPU).run(x=x, y=y)
    np.testing.assert_allclose(res["xr"], 0.6 * x + 0.8 * y, rtol=1e-6)
    np.testing.assert_allclose(res["yr"], 0.6 * y - 0.8 * x, rtol=1e-6)


def _fluent_jacobi(pkg, specs_):
    b = pkg.program("jac", dtype="float32")
    b.operand("A", "matrix").operand("b", "vector")
    b.operand("x0", "vector").operand("dinv", "vector")
    b.operand("omega", "scalar")
    b.setup(specs_.NRM2, inputs={"x": "b"}, outputs={"norm": "bnorm"})
    b.setup(specs_.RESIDUAL, inputs={"x": "x0"},
            outputs={"r": "r0", "rnorm": "rnorm0"})
    b.iterate(
        state={"x": "x0", "r": "r0"},
        body=[pkg.stage(specs_.JACOBI_UPDATE),
              pkg.stage(specs_.RESIDUAL, inputs={"x": "x_next"},
                        outputs={"r": "r_next", "rnorm": "rnorm"})],
        feedback={"x": "x_next", "r": "r_next"},
        stop={"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
              "rtol": 1e-6, "max_iters": 1000},
        guards={"nonfinite": ["x_next"],
                "divergence": {"factor": 1e4},
                "stagnation": {"window": 100}},
        solution={"x": "x"})
    return b


def test_fluent_loop_program_runs_and_matches_reference():
    b = _fluent_jacobi(blas, specs)
    raw = b.to_spec()
    assert raw == _fluent_jacobi(jblas, jspecs).to_spec()
    assert lowering.spec_digest(raw) == jlowering.spec_digest(
        dict(jspecs.JACOBI_LOOP, name="jac"))
    n = 48
    A, rhs = _diag_dominant(n), _rhs(n)
    from repro_torch.solvers.iterative import jacobi_dinv
    got = blas.compile(b, device=CPU).run(
        A=_t(A), b=_t(rhs), x0=torch.zeros(n), dinv=jacobi_dinv(_t(A)),
        omega=1.0)
    want = jblas.compile(_fluent_jacobi(jblas, jspecs)).run(
        A=jnp.asarray(A), b=jnp.asarray(rhs), x0=jnp.zeros(n),
        dinv=jnp.asarray(jacobi_dinv(_t(A)).numpy()),
        omega=jnp.float32(1.0))
    assert bool(got.converged)
    _assert_same_result(got, want)


def _fluent_gmres(pkg, specs_, m):
    """specs.gmres_loop(m) rebuilt through the loop-handle tier."""
    m1 = m + 1
    b = pkg.program("gmres", dtype="float32")
    b.operand("A", "matrix").operand("b", "vector")
    b.operand("x0", "vector")
    b.setup(specs_.NRM2, inputs={"x": "b"}, outputs={"norm": "bnorm"})
    b.setup(specs_.RESIDUAL, inputs={"x": "x0"},
            outputs={"r": "r0", "rnorm": "rnorm0"})
    x = b.state("x", init="x0")
    b.state("r", init="r0")
    b.state("rn", init="rnorm0", kind="scalar")
    b.feedback(x="x_next", r="r_next", rn="rnorm")
    arnoldi = b.inner_loop(
        counter="j",
        state={"V": {"kind": "stack", "slots": m1, "of": "vector",
                     "init": {"slot0": "v0"}},
               "Hc": {"kind": "stack", "slots": m, "of": "vector",
                      "len": m1},
               "gs": {"kind": "stack", "slots": m1, "of": "scalar",
                      "init": {"slot0": "rn"}}},
        body=[
            pkg.read("vj", "V", "j"),
            pkg.stage(specs_.GMRES_MATVEC, inputs={"v": "vj"}),
            pkg.stage(specs_.GMRES_PROJ, inputs={"g": "gs"}),
            pkg.stage(specs_.GMRES_ORTH),
            pkg.let(inv_hn="1 / hnorm"),
            pkg.stage(specs_.GMRES_SCAL,
                      inputs={"alpha": "inv_hn", "x": "w2"},
                      outputs={"out": "vnext"}),
            pkg.store("V", "j + 1", "vnext"),
            pkg.store("Hc", "j", "h"),
            pkg.store("Hc", "j", "hnorm", at="j + 1"),
        ],
        count=m,
        yields={"Vb": "V", "Hcb": "Hc", "g0": "gs"})
    givens = b.inner_loop(
        counter="t",
        state={"R": {"kind": "stack", "slots": m1, "of": "vector",
                     "init": {"from": "Hm"}},
               "g": {"kind": "stack", "slots": m1, "of": "scalar",
                     "init": {"from": "g0"}}},
        body=[
            pkg.read("rj", "R", "t"),
            pkg.read("rj1", "R", "t + 1"),
            pkg.read("hjj", "rj", "t"),
            pkg.read("hsub", "rj1", "t"),
            pkg.let(den="sqrt(hjj * hjj + hsub * hsub)",
                    c="hjj / den", s="hsub / den"),
            pkg.stage(specs_.GMRES_ROT),
            pkg.store("R", "t", "rja"),
            pkg.store("R", "t + 1", "rj1a"),
            pkg.read("gj", "g", "t"),
            pkg.let(gjn="c * gj", gj1n="-s * gj"),
            pkg.store("g", "t", "gjn"),
            pkg.store("g", "t + 1", "gj1n"),
        ],
        count=m,
        yields={"Rf": "R", "gf": "g"})
    backsub = b.inner_loop(
        counter="i",
        state={"y": {"kind": "stack", "slots": m, "of": "scalar"},
               "xa": {"init": "x"}},
        body=[
            pkg.let(q=f"{m - 1} - i"),
            pkg.read("Rq", "Rf", "q"),
            pkg.read("gq", "gf", "q"),
            pkg.stage(specs_.GMRES_DOT, inputs={"row": "Rq", "yv": "y"}),
            pkg.read("rqq", "Rq", "q"),
            pkg.let(yq="(gq - acc) / rqq"),
            pkg.store("y", "q", "yq"),
            pkg.read("vq", "Vb", "q"),
            pkg.stage(specs_.GMRES_AXPY,
                      inputs={"yq": "yq", "v": "vq", "x": "xa"},
                      outputs={"xn": "xn"}),
        ],
        count=m,
        feedback={"xa": "xn"},
        yields={"x_next": "xa"})
    b.iterate(
        body=[
            pkg.let(inv_beta="1 / rn"),
            pkg.stage(specs_.GMRES_SCAL,
                      inputs={"alpha": "inv_beta", "x": "r"},
                      outputs={"out": "v0"}),
            arnoldi,
            pkg.stage(specs_.GMRES_TRANSPOSE, inputs={"Hb": "Hcb"}),
            givens,
            backsub,
            pkg.stage(specs_.RESIDUAL, inputs={"x": "x_next"},
                      outputs={"r": "r_next", "rnorm": "rnorm"}),
        ],
        stop={"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
              "rtol": 1e-6, "max_iters": 50},
        guards={"nonfinite": ["x_next"],
                "divergence": {"factor": 1e4},
                "stagnation": {"window": 10}},
        solution={"x": x})          # a StateRef as the solution source
    return b


@pytest.mark.parametrize("m", [8, 20])
def test_fluent_gmres_digest_equals_reference_spec(m):
    b = _fluent_gmres(blas, specs, m)
    assert b.digest() == jlowering.spec_digest(jspecs.gmres_loop(m=m))
    assert b.to_spec() == _fluent_gmres(jblas, jspecs, m).to_spec()


def _fluent_bicgstab(pkg, specs_):
    b = pkg.program("bicgstab", dtype="float32")
    b.operand("A", "matrix").operand("b", "vector")
    b.operand("x0", "vector")
    b.setup(specs_.NRM2, inputs={"x": "b"}, outputs={"norm": "bnorm"})
    b.setup(specs_.RESIDUAL, inputs={"x": "x0"},
            outputs={"r": "r0", "rnorm": "rnorm0"})
    b.state("x", init="x0")
    b.state("r", init="r0")
    b.state("rhat", init="r0")
    b.state("p", init="r0")
    b.state("rho", init="rnorm0 * rnorm0", kind="scalar")
    b.feedback(x="x_next", r="r_next", p="p_next", rho="rho_next")
    b.iterate(
        body=[
            pkg.stage(specs_.BICG_MATVEC1),
            pkg.let(alpha="rho / rv", neg_alpha="-alpha"),
            pkg.stage(specs_.BICG_SUPDATE),
            b.cond(
                "snorm <= threshold",
                then=[
                    pkg.stage(specs_.BICG_XHALF,
                              outputs={"x_half": "x_next"}),
                    pkg.let(r_next="s", p_next="p", rho_next="rho",
                            rnorm="snorm"),
                ],
                orelse=[
                    pkg.stage(specs_.BICG_MATVEC2),
                    pkg.let(omega="ts / tt", neg_omega="-omega"),
                    pkg.stage(specs_.BICG_XRUPDATE),
                    pkg.let(beta="(rho_next / rho) * (alpha / omega)"),
                    pkg.stage(specs_.BICG_PUPDATE, inputs={"r": "r_next"}),
                ]),
        ],
        stop={"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
              "rtol": 1e-6, "max_iters": 200},
        guards={"nonfinite": ["x_next"],
                "breakdown": [{"value": "rv", "below": 1e-30}],
                "divergence": {"factor": 1e4},
                "stagnation": {"window": 50}},
        solution={"x": "x"})
    return b


def test_fluent_bicgstab_cond_digest_equals_reference_spec():
    b = _fluent_bicgstab(blas, specs)
    assert b.digest() == jlowering.spec_digest(jspecs.BICGSTAB_LOOP)
    assert b.to_spec() == _fluent_bicgstab(jblas, jspecs).to_spec()


def test_fluent_gmres_compiles_and_solves():
    exe = blas.compile(_fluent_gmres(blas, specs, 6), device=CPU)
    n = 32
    A, rhs = _nonsym(n, 5), _rhs(n, 6)
    res = exe.run(A=_t(A), b=_t(rhs), x0=torch.zeros(n), tol=1e-6)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, rhs),
                               rtol=1e-3, atol=1e-4)


def test_let_read_store_and_stage_helpers():
    st = blas.let(rz_next="rnorm * rnorm", beta="rz_next / rz")
    assert list(st["let"]) == ["rz_next", "beta"]
    v = blas.StateRef("V")
    assert blas.read("vj", v, "j")["read"]["from"] == "V"
    assert blas.store(v, "j", "w")["store"]["into"] == "V"
    assert blas.store(v, "j", "w", at="k")["store"]["at"] == "k"
    st = blas.inner_loop(state={"V": {"kind": "stack", "slots": 2,
                                      "of": "scalar"}},
                         body=[blas.let(z="1")], count=2,
                         yields={"out": blas.StateRef("V")})
    assert st["iterate"]["yield"]["out"] == "V"
    prog = blas.program("p")
    prog.dot(x="x", y="y")
    assert blas.stage(prog, inputs={"x": "a"})["program"] == prog.to_spec()
    with pytest.raises(blas.BuilderError, match="at least one binding"):
        blas.let()
    with pytest.raises(blas.BuilderError, match="stage program must be"):
        blas.stage(42)


# ---------------------------------------------------------------------------
# ProgramBuilder: misuse and its messages
# ---------------------------------------------------------------------------


def test_state_and_feedback_handles_misuse():
    b = blas.program("p")
    b.state("x", init="x0")
    with pytest.raises(blas.BuilderError, match="duplicate state"):
        b.state("x", init="x0")
    with pytest.raises(blas.BuilderError, match="slot0=.*not init="):
        b.state("V", init="x0", slots=4, of="vector")
    with pytest.raises(blas.BuilderError, match="slot0=.*conflict"):
        b.state("V", slots=4, of="vector", slot0="a", from_="buf")
    with pytest.raises(blas.BuilderError, match="needs init="):
        b.state("y")
    b.feedback(x="x_next")
    with pytest.raises(blas.BuilderError, match="b.state.*AND passed"):
        b.iterate(state={"x": "x0"}, body=[blas.let(a="1")],
                  stop={"metric": "a", "max_iters": 1})
    b2 = blas.program("df")
    b2.axpy(alpha=1.0, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="dataflow builder"):
        b2.state("x", init="x0")
    with pytest.raises(blas.BuilderError, match="dataflow builder"):
        b2.feedback(x="x_next")


def test_inner_loop_needs_exactly_one_stop_form():
    with pytest.raises(blas.BuilderError, match="exactly one of"):
        blas.inner_loop(state={"h": "a"}, body=[blas.let(z="h")])
    with pytest.raises(blas.BuilderError, match="exactly one of"):
        blas.inner_loop(state={"h": "a"}, body=[blas.let(z="h")], count=3,
                        stop={"metric": "z", "max_iters": 3})


def test_unknown_routine_and_port_name_the_valid_ones():
    b = blas.program("p")
    with pytest.raises(AttributeError, match="frobnicate"):
        b.frobnicate(x="x")
    with pytest.raises(blas.BuilderError, match="unknown BLAS routine"):
        b.add("frobnicate", x="x")
    with pytest.raises(blas.BuilderError, match=r"no port or scalar 'w'"):
        b.dot(w="u")
    with pytest.raises(blas.BuilderError, match=r"inputs: \['x', 'y'\]"):
        b.dot(w="u")


def test_duplicate_dangling_and_scalar_port_misuse():
    b = blas.program("p")
    b.axpy(name="up", alpha=1.0, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="duplicate routine name"):
        b.axpy(name="up", alpha=1.0, x="x", y="y")
    z = blas.program("p1").axpy(alpha=1.0, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="different builder"):
        b.dot(x=z, y="u")
    d = b.dot(x="x", y="y")
    with pytest.raises(blas.BuilderError, match="scalar stream"):
        b.axpy(alpha=d, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="single-output"):
        b.rot(c=1.0, s=0.0, x="x", y="y", out="rotated")
    with pytest.raises(blas.BuilderError, match="identifier"):
        b.input("not an identifier")


def test_mixing_dataflow_and_loop_construction_rejected():
    b = blas.program("p")
    b.axpy(alpha=1.0, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="dataflow builder"):
        b.operand("A", "matrix")
    b2 = blas.program("q")
    b2.operand("A", "matrix")
    with pytest.raises(blas.BuilderError, match="loop builder"):
        b2.axpy(alpha=1.0, x="x", y="y")
    with pytest.raises(blas.BuilderError, match="no iterate"):
        b2.to_spec()
    with pytest.raises(blas.BuilderError, match="window_size"):
        blas.program("loopy", window_size=512).operand("A", "matrix")
    with pytest.raises(blas.BuilderError, match="unknown kind"):
        blas.program("k").operand("A", "tensor")


def test_failed_add_leaves_builder_unchanged():
    b = blas.program("p")
    z = b.axpy(alpha=1.0, x="v", y="w")
    before = b.to_spec()
    with pytest.raises(blas.BuilderError):
        b.dot(x=z, y="u", out={"bogus": "beta"})
    assert b.to_spec() == before       # no dangling connection
    b.dot(x=z, y="u", out="beta")      # retry now succeeds...
    exe = blas.compile(b, device=CPU)  # ...and compiles cleanly
    assert exe.output_names == ["beta"]


def test_build_validates_through_the_spec_layer():
    b = blas.program("p")
    b.axpy(alpha=1.0, x="x", y="y")
    assert isinstance(b.build(), spec_mod.ProgramSpec)
    assert isinstance(_fluent_bicgstab(blas, specs).build(),
                      spec_mod.LoopSpec)
    with pytest.raises(spec_mod.SpecError, match="no routines"):
        blas.program("nothing").build()
    with pytest.raises(blas.BuilderError, match="unsupported dtype"):
        blas.program("p", dtype="float64")


def test_routine_binds_arguments_as_its_signature_says():
    x, y = torch.arange(4.0), torch.ones(4)
    want = blas.axpy(2.0, x, y, device=CPU)
    for call in (lambda: blas.axpy(2.0, x=x, y=y, device=CPU),
                 lambda: blas.axpy(y=y, alpha=2.0, x=x, device=CPU)):
        assert torch.equal(call(), want)
    for bad, match in ((lambda: blas.axpy(2.0, x, y, x, device=CPU),
                        "positional"),
                       (lambda: blas.axpy(2.0, x, y, z=x, device=CPU),
                        "unexpected keyword"),
                       (lambda: blas.axpy(2.0, x, y, alpha=1.0,
                                          device=CPU), "multiple values"),
                       (lambda: blas.axpy(2.0, x, device=CPU), "missing")):
        with pytest.raises(TypeError, match=match):
            bad()
