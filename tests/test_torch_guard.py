"""Port parity for `repro_torch.guard` — fault plans, the in-loop guards
under injected faults, the escalation ladder behind `blas.solve` and the
chaos drill — against `repro.guard`, on the CPU, at the reference tests'
sizes (n = 24, block-CG with 3 right-hand sides), on the same seeded
numpy operands. Mirrors tests/test_guard.py (its RV5xx cases held to
the reference's static analyzer, with the RV504 case of
tests/test_verify.py) and the batched solve's per-lane status, plus
the watchdog cases of tests/test_checkpoint_ft.py.

What must agree with the reference, exactly: each drill cell's status
name and iteration count (all 23 solver cells in reference mode; the
CG, block-CG and GMRES cells in dataflow mode too); the escalation
tests' attempt logs as (solver, action, status name); the `guard.*`
obs events' names and their solver, action, status and iteration
attributes; and every corrupted value of `chaos.corrupt`, bit for bit
(NaN compared as NaN), in float32, bfloat16, float16 and int32.
Solutions are held to a float64 solve within atol 1e-3 (the solvers
stop at rtol 1e-6 of |b| on systems whose condition number is below
10), the float64 rung within 1e-6, and `_dense_f64` against numpy's
float64 solve within 1e-10 relative.
"""
import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jblas, obs as jobs
from repro.guard import chaos as jchaos
from repro.guard import escalate as jescalate
from repro.guard import status as JST
from repro.solvers import iterative as jiterative
from repro.solvers import specs as jspecs
from repro.tune import store as jstore
from repro_torch import blas, obs
from repro_torch.blas import executable as bexe, solvers as bsolvers
from repro_torch.core import lowering, runtime
from repro_torch.core.spec import SpecError
from repro_torch.ft.watchdog import HeartbeatMonitor, StragglerWatchdog
from repro_torch.guard import __main__ as guard_main
from repro_torch.guard import chaos, escalate
from repro_torch.guard import status as ST
from repro_torch.solvers import LoopProgram, iterative, specs
from repro_torch.tune import store as tune_store

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

N = 24
DETECTION_SLACK = 2
CPU = "cpu"


@pytest.fixture(autouse=True)
def private_tuning_stores(monkeypatch, tmp_path):
    """Both packages' tuning stores live in a temporary directory for
    the test and are re-read from the real environment after it."""
    monkeypatch.setenv(jstore.ENV_CACHE_DIR, str(tmp_path / "ref-tune"))
    monkeypatch.setenv(tune_store.ENV_CACHE_DIR, str(tmp_path / "tune"))
    jstore.reset_store()
    tune_store.reset_store()
    yield
    jstore.reset_store()
    tune_store.reset_store()


def _spd(n=N, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


def _rhs(n=N, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(
        np.float32)


def _nonsym(n=N, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32)
            / np.sqrt(n) + 3.0 * np.eye(n, dtype=np.float32)).astype(
                np.float32)


def _x_ref(a, b):
    return np.linalg.solve(np.asarray(a, np.float64),
                           np.asarray(b, np.float64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _log(attempts):
    return [(at.solver, at.action, at.status_name) for at in attempts]


def _jplan(plan):
    return jchaos.FaultPlan(**{f: getattr(plan, f) for f in
                               ("program", "kind", "output", "iteration",
                                "factor", "seed")})


# -- status codes -----------------------------------------------------------


def test_status_names_and_failure_predicate():
    assert ST.status_name(ST.CONVERGED) == "CONVERGED"
    assert ST.status_name(ST.BREAKDOWN) == "BREAKDOWN"
    assert not ST.is_failure(ST.CONVERGED)
    for code in (ST.MAX_ITERS, ST.BREAKDOWN, ST.NONFINITE,
                 ST.DIVERGED, ST.STAGNATED):
        assert ST.is_failure(code)
    assert ST.STATUS_NAMES == JST.STATUS_NAMES


def test_healthy_solves_report_converged():
    a, b = _t(_spd()), _t(_rhs())
    for fn in (blas.cg, blas.bicgstab):
        res = fn(a, b, tol=1e-6, device=CPU)
        assert res.status_names() == "CONVERGED"
        assert bool(res.converged)
        assert res.attempts is None       # a plain solve keeps no log


# -- fault plans ------------------------------------------------------------


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        chaos.FaultPlan(program="cg", kind="meteor")
    with pytest.raises(ValueError):
        chaos.FaultPlan(program="", kind="nan")
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS


def test_fault_plan_matching_is_prefix_aware():
    plan = chaos.FaultPlan(program="cg", kind="nan")
    assert plan.matches("cg")
    assert plan.matches("cg_matvec")
    assert not plan.matches("cgs")           # no underscore boundary
    assert not plan.matches("bicg_matvec")
    assert not plan.matches(None)
    assert chaos.FaultPlan(program="*", kind="nan").matches("anything")
    assert plan.key() == _jplan(plan).key()


_VALUES = {
    "f32_vec": np.array([1.5, 1.25, -3.0, 0.1, 7.0], np.float32),
    "f32_scalar": np.array(2.0, np.float32),
    "int32_vec": np.array([5, -7, 1 << 20], np.int32),
    "int32_scalar": np.array(5, np.int32),      # iamax's index
}
_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float16": (torch.float16, jnp.float16)}
_KINDS = [("nan", {}), ("inf", {}), ("scale", {}),
          ("scale", {"factor": 0.0}), ("scale", {"factor": -3.0}),
          ("scale", {"factor": 2.5}), ("bitflip", {}),
          ("bitflip", {"seed": 2}), ("bitflip", {"seed": 7})]


def _corrupt_cases():
    for kind, kw in _KINDS:
        for vname, val in _VALUES.items():
            dts = ["int32"] if val.dtype == np.int32 else list(_DTYPES)
            for dt in dts:
                label = f"{kind}-{kw}-{vname}-{dt}"
                yield pytest.param(kind, kw, vname, dt, id=label)


@pytest.mark.parametrize("kind,kw,vname,dt", _corrupt_cases())
def test_corrupt_matches_reference(kind, kw, vname, dt):
    """Every kind on float and integer outputs gives the reference's
    value, bit for bit, or the same exception (scale's default 1e20
    does not fit an int32, in both packages); the output is a new
    tensor and the input is left as it was."""
    val = _VALUES[vname]
    tv, jv = _t(val.copy()), jnp.asarray(val)
    if dt != "int32":
        tv, jv = tv.to(_DTYPES[dt][0]), jv.astype(_DTYPES[dt][1])
    plan = chaos.FaultPlan(program="*", kind=kind, **kw)
    try:
        want = np.asarray(jchaos.corrupt(jv, _jplan(plan)).astype(
            jnp.float32))
    except (OverflowError, ValueError) as e:
        with pytest.raises(type(e)):
            chaos.corrupt(tv, plan)
        return
    before = tv.clone()
    got = chaos.corrupt(tv, plan)
    assert got is not tv and got.dtype == tv.dtype
    assert torch.equal(tv, before) or kind == "nan"
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_iteration_plans_are_dormant_outside_loops():
    """Outside a driver body an iteration-targeted plan leaves the
    program alone; `iteration=None` fires on every call."""
    x, y = torch.arange(1.0, 9.0), torch.ones(8)
    clean = runtime.Program.from_spec(runtime.AXPY_SPEC, device=CPU)
    want = clean(alpha=0.5, x=x, y=y)["out"]
    for iteration, fires in ((3, False), (None, True)):
        plan = chaos.FaultPlan(program="*", kind="nan",
                               iteration=iteration)
        ir = lowering.compile_cached(runtime.AXPY_SPEC, device=CPU,
                                     fault=plan)
        got = ir.fn({"alpha": 0.5, "x": x, "y": y})["out"]
        assert bool(torch.isnan(got).all()) == fires
        if not fires:
            assert torch.equal(got, want)
    with chaos.loop_iteration(3):
        assert chaos.current_iteration() == 3
        got = ir.fn({"alpha": 0.5, "x": x, "y": y})["out"]
    assert chaos.current_iteration() is None


# -- in-loop detection ------------------------------------------------------


def _run_loop(raw, plan, ins, *, mode="dataflow", max_iters=100):
    exe = blas.compile(raw, mode=mode, max_iters=max_iters, device=CPU,
                       fault=plan)
    return exe.run(tol=1e-6, **{k: _t(v) if isinstance(v, np.ndarray)
                                else v for k, v in ins.items()})


def _run_loop_ref(raw, plan, ins, *, mode="dataflow", max_iters=100):
    exe = jblas.compile(raw, mode=mode, max_iters=max_iters,
                        tiles="default", fault=_jplan(plan))
    return exe.run(tol=1e-6, **{k: jnp.asarray(v)
                                for k, v in ins.items()})


@pytest.mark.parametrize("kind,expect", [
    ("nan", {ST.NONFINITE}),
    ("inf", {ST.NONFINITE}),
    ("bitflip", {ST.NONFINITE, ST.DIVERGED, ST.BREAKDOWN}),
    ("scale", {ST.DIVERGED, ST.NONFINITE}),
])
def test_cg_detects_every_fault_kind(kind, expect):
    a, b = _spd(), _rhs()
    inject_at = 3
    plan = chaos.FaultPlan(program="cg", kind=kind, iteration=inject_at)
    ins = {"A": a, "b": b, "x0": np.zeros_like(b)}
    res = _run_loop(specs.CG_LOOP, plan, ins)
    code = int(res.status)
    assert code in expect, ST.status_name(code)
    assert int(res.iterations) <= inject_at + DETECTION_SLACK
    jres = _run_loop_ref(jspecs.CG_LOOP, plan, ins)
    assert (code, int(res.iterations)) == \
        (int(np.asarray(jres.status)), int(jres.iterations))


def test_scale_zero_provokes_breakdown():
    a, b = _spd(), _rhs()
    plan = chaos.FaultPlan(program="cg_matvec", kind="scale",
                           factor=0.0, iteration=2, output="pq")
    ins = {"A": a, "b": b, "x0": np.zeros_like(b)}
    res = _run_loop(specs.CG_LOOP, plan, ins)
    assert res.status_names() == "BREAKDOWN"
    assert int(res.iterations) <= 2 + DETECTION_SLACK
    jres = _run_loop_ref(jspecs.CG_LOOP, plan, ins)
    assert int(res.iterations) == int(jres.iterations)


def test_setup_stages_leave_an_iteration_plan_dormant():
    """A plan on every program ('*') at iteration 0 compiles the setup's
    residual program faulted too, but only the first body iteration
    fires: one iteration, NONFINITE, as in the reference."""
    a, b = _spd(), _rhs()
    plan = chaos.FaultPlan(program="*", kind="nan", iteration=0)
    ins = {"A": a, "b": b, "x0": np.zeros_like(b)}
    res = _run_loop(specs.CG_LOOP, plan, ins)
    jres = _run_loop_ref(jspecs.CG_LOOP, plan, ins)
    assert (res.status_names(), int(res.iterations)) == \
        ("NONFINITE", 1) == (JST.status_name(int(np.asarray(
            jres.status))), int(jres.iterations))


@pytest.mark.parametrize("target,iteration", [
    ("gmres_orth", 1),      # a stage of the nested Arnoldi loop
    ("gmres_orth", 40),     # past the last restart: never fires
])
def test_gmres_inner_stages_see_the_restart_index(target, iteration):
    """GMRES's nested loops run inside the outer body, so their stages
    see the restart index; a plan past the last restart never fires and
    leaves the solve bitwise clean."""
    a, b = _nonsym(), _rhs()
    plan = chaos.FaultPlan(program=target, kind="nan",
                           iteration=iteration)
    ins = {"A": a, "b": b, "x0": np.zeros_like(b)}
    raw, jraw = specs.gmres_loop(8), jspecs.gmres_loop(8)
    res = _run_loop(raw, plan, ins, max_iters=None)
    jres = _run_loop_ref(jraw, plan, ins, max_iters=None)
    assert (res.status_names(), int(res.iterations)) == \
        (JST.status_name(int(np.asarray(jres.status))),
         int(jres.iterations))
    if iteration == 40:
        clean = blas.compile(raw, device=CPU).run(
            tol=1e-6, A=_t(a), b=_t(b), x0=torch.zeros(N))
        assert torch.equal(res.x, clean.x)
    else:
        assert res.status_names() == "NONFINITE"
        assert int(res.iterations) == iteration + 1


def test_detection_is_deterministic():
    a, b = _spd(), _rhs()
    plan = chaos.FaultPlan(program="cg", kind="bitflip", iteration=3,
                           seed=7)
    ins = {"A": a, "b": b, "x0": np.zeros_like(b)}
    outs = []
    for _ in range(2):
        res = _run_loop(specs.CG_LOOP, plan, ins)
        outs.append((int(res.status), int(res.iterations), res.x))
    assert outs[0][:2] == outs[1][:2]
    # bitwise, NaN where NaN
    np.testing.assert_array_equal(outs[0][2].numpy(), outs[1][2].numpy())


def test_faulted_compile_never_poisons_the_clean_cache(monkeypatch):
    """A faulted compile neither reads nor fills the program cache (a
    loop's clean stages still share it), and `blas.solve` never serves
    or stores its faulted first attempt in the solver functions' memo."""
    a, b = _spd(), _rhs()
    plan = chaos.FaultPlan(program="*", kind="nan", iteration=1)
    blas.compile(runtime.AXPY_SPEC, device=CPU)
    before = lowering.cache_stats()
    for raw in (runtime.AXPY_SPEC, specs.CG_LOOP):
        blas.compile(raw, device=CPU, fault=plan)
    assert lowering.cache_stats() == before
    faulted = []
    real = bexe.compile

    def spy(*args, **kw):
        exe = real(*args, **kw)
        if kw.get("fault") is not None:
            faulted.append(exe)
        return exe

    monkeypatch.setattr(bexe, "compile", spy)
    rec = blas.solve(_t(a), _t(b), tol=1e-6, device=CPU,
                     fault=chaos.FaultPlan(program="cg", kind="nan",
                                           iteration=1))
    assert len(faulted) == 1 and rec.attempts[0].status_name == \
        "NONFINITE"
    assert not any(e is faulted[0]
                   for e in bsolvers._EXECUTABLES.values())
    assert all(getattr(ir.fn, "__name__", "") != "faulted"
               for ir in lowering._CACHE.values())
    clean = blas.cg(_t(a), _t(b), tol=1e-6, device=CPU)
    assert clean.status_names() == "CONVERGED"
    np.testing.assert_allclose(clean.x.numpy(), _x_ref(a, b), atol=1e-3)


# -- guards do not perturb healthy numerics ---------------------------------


def _stripped(raw):
    raw = copy.deepcopy(raw)
    raw["iterate"].pop("guards")
    return raw


def test_guarded_solve_bit_identical_to_unguarded():
    """Guard predicates ride beside the math: a healthy solve with
    guards is bitwise the solve without them."""
    a, b = _t(_spd()), _t(_rhs())
    x0 = torch.zeros(N)
    guarded = blas.compile(specs.CG_LOOP, max_iters=100, device=CPU).run(
        A=a, b=b, x0=x0, tol=1e-6)
    plain = blas.compile(_stripped(specs.CG_LOOP), max_iters=100,
                         device=CPU).run(A=a, b=b, x0=x0, tol=1e-6)
    assert int(guarded.iterations) == int(plain.iterations)
    assert torch.equal(guarded.x, plain.x)
    assert torch.equal(guarded.residual, plain.residual)


# -- batched per-lane status ------------------------------------------------


def test_batched_mixed_lanes_per_lane_status():
    """tests/test_guard.py:182: one NaN-poisoned lane in a batch reports
    NONFINITE within one iteration, as the reference's does; the
    healthy lanes converge bitwise as in a batched run without guards,
    and their statuses and iterations are the reference's."""
    a = _spd()
    bs = np.stack([_rhs(seed=s) for s in (1, 2, 3)])
    bad = 1
    bs[bad, 5] = np.nan
    x0 = np.zeros_like(bs)
    res = blas.compile(specs.CG_LOOP, max_iters=100, device=CPU).batched(
        A=_t(a), b=_t(bs), x0=_t(x0), tol=1e-6)
    want = jblas.compile(jspecs.CG_LOOP, max_iters=100).batched(
        A=jnp.asarray(a), b=jnp.asarray(bs), x0=jnp.asarray(x0), tol=1e-6)
    names = res.status_names()
    assert names == want.status_names() == \
        ["CONVERGED", "NONFINITE", "CONVERGED"]
    assert res.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert int(res.iterations[bad]) <= 1
    plain = blas.compile(_stripped(specs.CG_LOOP), max_iters=100,
                         device=CPU).batched(A=_t(a), b=_t(bs), x0=_t(x0),
                                             tol=1e-6)
    for lane in (0, 2):
        assert torch.equal(res.x[lane], plain.x[lane])
        assert int(res.iterations[lane]) == int(plain.iterations[lane])
        np.testing.assert_allclose(res.x[lane].numpy(),
                                   _x_ref(a, bs[lane]), atol=1e-3)


# -- the chaos drill against the reference ---------------------------------


def _drill_cell_ref(solver, kind, extra, mode):
    """The reference drill's detection half: status name and
    iterations of its faulted compile, on the same system."""
    a, b = guard_main._system(rhs=3 if solver == "block_cg" else 0)
    target, inject_at = guard_main.TARGETS[solver]
    plan = jchaos.FaultPlan(program=target, kind=kind,
                            iteration=inject_at, **extra)
    raw = {"cg": jspecs.CG_LOOP, "bicgstab": jspecs.BICGSTAB_LOOP,
           "jacobi": jspecs.JACOBI_LOOP,
           "block_cg": jspecs.BLOCK_CG_LOOP}.get(solver)
    kw = {"max_iters": 100}
    if raw is None:
        raw, kw = jspecs.gmres_loop(8), {}
    exe = jblas.compile(raw, mode=mode, tiles="default", fault=plan, **kw)
    ins = {"A": a, ("B" if solver == "block_cg" else "b"): b,
           "x0": jnp.zeros_like(b)}
    if solver == "jacobi":
        ins["dinv"] = jiterative.jacobi_dinv(a, b.dtype)
        ins["omega"] = jnp.float32(1.0)
    res = exe.run(tol=1e-6, **ins)
    return JST.status_name(int(np.asarray(res.status))), \
        int(res.iterations)


def _cells(solvers=None):
    for solver, kind, extra in guard_main._case_matrix():
        if solvers is None or solver in solvers:
            label = f"{solver}-{kind}" + ("-factor0" if extra else "")
            yield pytest.param(solver, kind, extra, id=label)


@pytest.mark.parametrize("solver,kind,extra", _cells())
def test_drill_cell_matches_reference_in_reference_mode(solver, kind,
                                                        extra):
    row = guard_main._run_cell(solver, kind, extra, mode="reference",
                               device=CPU)
    assert row["ok"], row
    assert (row["status"], row["iterations"]) == \
        _drill_cell_ref(solver, kind, extra, "reference")


@pytest.mark.parametrize("solver,kind,extra",
                         _cells(("cg", "block_cg", "gmres")))
def test_drill_cell_matches_reference_in_dataflow_mode(solver, kind,
                                                       extra):
    row = guard_main._run_cell(solver, kind, extra, mode="dataflow",
                               device=CPU)
    assert row["ok"], row
    assert (row["status"], row["iterations"]) == \
        _drill_cell_ref(solver, kind, extra, "dataflow")


def test_chaos_smoke_cli_reports_every_cell(tmp_path, capsys):
    report = tmp_path / "chaos.json"
    assert guard_main.main(["--chaos-smoke", "--device", "cpu",
                            "--report", str(report)]) == 0
    assert "chaos smoke: 25/25 cells passed" in capsys.readouterr().out
    doc = json.loads(report.read_text())
    assert (doc["cases"], doc["failed"], doc["mode"]) == \
        (25, 0, "dataflow")
    assert doc["detection_slack"] == DETECTION_SLACK


def test_chaos_smoke_counts_a_crash_as_a_failed_cell(monkeypatch):
    """A cell that raises is a failed cell with the exception in its
    row, and the drill's report counts it."""
    def boom(*a, **k):
        raise RuntimeError("injected crash")

    monkeypatch.setattr(guard_main, "_compile_faulted", boom)
    row = guard_main._run_cell("cg", "nan", {}, device=CPU)
    assert row["ok"] is False
    assert row["error"] == "RuntimeError: injected crash"
    monkeypatch.setattr(guard_main, "_case_matrix",
                        lambda: [("cg", "nan", {})])
    report = guard_main.chaos_smoke(device=CPU, quiet=True)
    assert report["failed"] == 1 and report["cases"] == 3


def test_chaos_smoke_cli_importable():
    cases = guard_main._case_matrix()
    solvers = {c[0] for c in cases}
    assert solvers == {"cg", "bicgstab", "jacobi", "gmres", "block_cg"}
    assert {c[1] for c in cases} == set(chaos.FAULT_KINDS)
    assert len(cases) == 23
    from repro.guard import __main__ as jguard_main
    assert cases == jguard_main._case_matrix()
    assert guard_main.TARGETS == jguard_main.TARGETS
    assert guard_main.DETECTION_SLACK == jguard_main.DETECTION_SLACK


# -- escalation -------------------------------------------------------------


def test_escalation_policy_validation():
    with pytest.raises(ValueError):
        escalate.EscalationPolicy(chain=())
    with pytest.raises(ValueError):
        escalate.EscalationPolicy(chain=("warp_drive",))
    with pytest.raises(ValueError):
        escalate.EscalationPolicy(max_attempts=0)
    assert blas.EscalationPolicy is escalate.EscalationPolicy
    assert blas.RecoveryError is escalate.RecoveryError
    assert escalate._ladder(escalate.EscalationPolicy()) == \
        jescalate._ladder(jescalate.EscalationPolicy())


def _guard_records(recs):
    keep = ("solver", "action", "status", "iterations", "straggler",
            "attempts")
    return [(r["kind"], r["name"],
             {k: v for k, v in r.get("attrs", {}).items() if k in keep})
            for r in recs if r["name"].startswith("guard.")]


def test_retry_recovers_from_transient_fault():
    """A fault on the first attempt only (the chaos contract) is exactly
    a transient: retry-with-restart must recover, with the reference's
    attempt log and `guard.*` records."""
    a, b = _spd(), _rhs()
    plan = chaos.FaultPlan(program="cg", kind="nan")
    with obs.capture() as reg:
        res = blas.solve(_t(a), _t(b), tol=1e-6, device=CPU, fault=plan)
    with jobs.capture() as jreg:
        jres = jblas.solve(a, b, tol=1e-6, fault=_jplan(plan))
    assert res.status_names() == "CONVERGED"
    assert _log(res.attempts) == _log(jres.attempts) == \
        [("cg", "initial", "NONFINITE"), ("cg", "retry", "CONVERGED")]
    assert [at.iterations for at in res.attempts] == \
        [at.iterations for at in jres.attempts]
    assert _guard_records(reg.records) == _guard_records(jreg.records)
    assert reg.counters["guard.recovered"] == 1
    np.testing.assert_allclose(res.x.numpy(), _x_ref(a, b), atol=1e-3)


def test_escalation_switches_cg_to_bicgstab():
    """CG on a nonsymmetric system burns its iteration budget; the
    driver degrades to BiCGStab and comes back correct."""
    a, b = _nonsym(), _rhs()
    policy = escalate.EscalationPolicy(retry_restart=False)
    res = blas.solve(_t(a), _t(b), tol=1e-6, max_iters=8, policy=policy,
                     device=CPU)
    jres = jblas.solve(a, b, tol=1e-6, max_iters=8,
                       policy=jescalate.EscalationPolicy(
                           retry_restart=False))
    assert res.status_names() == "CONVERGED"
    assert _log(res.attempts) == _log(jres.attempts)
    assert res.attempts[0].solver == "cg"
    assert res.attempts[-1].solver == "bicgstab"
    assert ST.is_failure(res.attempts[0].status)
    np.testing.assert_allclose(res.x.numpy(), _x_ref(a, b), atol=1e-3)


def test_escalation_f64_last_resort():
    """Chain exhausted -> float64 dense direct solve on the operands'
    device."""
    a, b = _spd(), _rhs()
    policy = escalate.EscalationPolicy(chain=("cg",), retry_restart=False)
    res = blas.solve(_t(a), _t(b), tol=1e-6, max_iters=1, policy=policy,
                     device=CPU)
    jres = jblas.solve(a, b, tol=1e-6, max_iters=1,
                       policy=jescalate.EscalationPolicy(
                           chain=("cg",), retry_restart=False))
    assert _log(res.attempts) == _log(jres.attempts) == \
        [("cg", "initial", "MAX_ITERS"),
         ("dense_f64", "escalate_f64", "CONVERGED")]
    assert res.status_names() == "CONVERGED"
    assert res.x.dtype == torch.float64 and res.x.device.type == "cpu"
    np.testing.assert_allclose(res.x.numpy(), _x_ref(a, b), atol=1e-6)


def test_recovery_error_carries_attempts():
    a, b = _spd(), _rhs()
    policy = escalate.EscalationPolicy(chain=("cg",), retry_restart=False,
                                       escalate_f64=False)
    with pytest.raises(escalate.RecoveryError) as ei:
        blas.solve(_t(a), _t(b), tol=1e-6, max_iters=1, policy=policy,
                   device=CPU)
    with pytest.raises(jescalate.RecoveryError) as jei:
        jblas.solve(a, b, tol=1e-6, max_iters=1,
                    policy=jescalate.EscalationPolicy(
                        chain=("cg",), retry_restart=False,
                        escalate_f64=False))
    assert len(ei.value.attempts) == 1
    assert ei.value.attempts[0].status == ST.MAX_ITERS
    assert _log(ei.value.attempts) == _log(jei.value.attempts)
    assert str(ei.value) == str(jei.value)


def test_panel_right_hand_side_runs_block_cg():
    """A matrix b runs the panel chain (block-CG, then float64), and a
    chain with a vector solver is refused, as in the reference."""
    a = _spd()
    bs = np.random.default_rng(5).standard_normal((N, 3)).astype(
        np.float32)
    res = blas.solve(_t(a), _t(bs), tol=1e-6, device=CPU)
    jres = jblas.solve(a, bs, tol=1e-6)
    assert _log(res.attempts) == _log(jres.attempts) == \
        [("block_cg", "initial", "CONVERGED")]
    np.testing.assert_allclose(res.x.numpy(), _x_ref(a, bs), atol=1e-3)
    with pytest.raises(ValueError, match="panel-capable"):
        blas.solve(_t(a), _t(bs), device=CPU,
                   policy=escalate.EscalationPolicy(chain=("cg",)))


@pytest.mark.parametrize("case", ["vector", "panel", "singular"])
def test_dense_f64_agrees_with_numpy(case):
    """The last rung against numpy's float64 solve: 1e-10 relative; a
    singular A gives NaN and NONFINITE, as numpy's LinAlgError does in
    the reference."""
    a = _spd()
    b = _rhs() if case != "panel" else \
        np.random.default_rng(6).standard_normal((N, 3)).astype(np.float32)
    if case == "singular":
        a = a.copy()
        a[:, 3] = 0.0
        a[3, :] = 0.0
    res = escalate._dense_f64(_t(a), _t(b), 1e-6)
    jres = jescalate._dense_f64(a, b, 1e-6)
    assert int(res.status) == int(np.asarray(jres.status))
    if case == "singular":
        assert res.status_names() == "NONFINITE"
        assert bool(torch.isnan(res.x).all())
        return
    want = _x_ref(a, b)
    got = res.x.numpy()
    assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want)
    assert res.status_names() == "CONVERGED"
    assert int(res.iterations) == 1 and res.aux["method"] == "dense_f64"


def test_warm_start_reads_the_last_finite_iterate(monkeypatch):
    """The retry starts from the failed attempt's x when it is finite,
    and from the caller's x0 when it is not."""
    a, b = _t(_spd()), _t(_rhs())
    starts = []
    real = escalate._run_iterative

    def spy(solver, A, b_, x0, **kw):
        starts.append(x0)
        return real(solver, A, b_, x0, **kw)

    monkeypatch.setattr(escalate, "_run_iterative", spy)
    blas.solve(a, b, tol=1e-6, device=CPU,
               fault=chaos.FaultPlan(program="cg", kind="nan"))
    assert starts[0] is None and starts[1] is None     # NaN x: no warm start
    starts.clear()
    res = blas.solve(a, b, tol=1e-6, max_iters=2, device=CPU,
                     policy=escalate.EscalationPolicy(chain=("cg",)))
    assert starts[0] is None and starts[1] is not None
    assert res.attempts[1].action == "retry"


# -- watchdog, heartbeat ----------------------------------------------------


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, min_samples=5)
    for i in range(20):
        assert not wd.record(i, 1.0)
    assert wd.record(20, 3.5)          # 3.5x median
    assert not wd.record(21, 1.4)
    assert wd.slow_steps == [20]
    assert wd.median == 1.0


def test_heartbeat_monitor_failure_fires_once():
    t = [0.0]
    failed = []
    mon = HeartbeatMonitor(hosts=["h0", "h1"], interval_s=1.0,
                           suspect_after=2, dead_after=5,
                           on_failure=failed.append,
                           clock=lambda: t[0])
    t[0] = 3.0
    mon.beat("h0")
    assert mon.status("h1") == "suspected"
    assert mon.poll() == []
    t[0] = 6.0
    mon.beat("h0")
    assert mon.poll() == ["h1"]
    assert mon.poll() == []            # fires exactly once
    assert failed == ["h1"]
    assert mon.alive_hosts == ["h0"]
    # elastic rejoin
    mon.beat("h1")
    assert mon.status("h1") == "alive"


def test_heartbeat_monitor_elastic_join():
    t = [0.0]
    mon = HeartbeatMonitor(hosts=["a"], interval_s=1.0,
                           clock=lambda: t[0])
    mon.beat("newcomer")            # unknown host: must not KeyError
    assert "newcomer" in mon.hosts
    assert mon.status("newcomer") == "alive"
    t[0] = 10.0                     # newcomer goes silent too
    dead = mon.poll()
    assert set(dead) == {"a", "newcomer"}
    mon.beat("newcomer")            # and rejoins fresh
    assert mon.status("newcomer") == "alive"
    assert "newcomer" in mon.alive_hosts


def test_heartbeat_known_host_flow_unchanged():
    t = [0.0]
    fired = []
    mon = HeartbeatMonitor(hosts=["a", "b"], interval_s=1.0,
                           on_failure=fired.append,
                           clock=lambda: t[0])
    t[0] = 3.0
    mon.beat("a")
    assert mon.status("a") == "alive"
    assert mon.status("b") == "suspected"
    t[0] = 7.5       # a missed 4.5 beats (suspected), b 7.5 (dead)
    assert mon.poll() == ["b"]
    assert fired == ["b"]
    assert mon.poll() == []         # fires exactly once per incident


# -- filesystem chaos / tuning-store hardening ------------------------------


def _seeded_table(path):
    table = tune_store.TuningTable(path)
    table.doc["seq"] = 1
    table.doc["entries"]["gemv|64|dataflow|fuse=1|anchor=1|cpu"] = {
        "tiles": {"block_m": 8, "block_n": 8, "block_k": 8}, "us": 1.0,
        "default_us": 2.0, "seq": 1}
    table.save()
    return table


@pytest.mark.parametrize("damage", [
    chaos.corrupt_json,
    lambda p: chaos.truncate_file(p, fraction=0.4),
])
def test_store_quarantines_corrupt_table(tmp_path, damage):
    path = tmp_path / "tuning_table.json"
    _seeded_table(path)
    damage(path)
    with obs.capture() as reg:
        reread = tune_store.TuningTable(path)       # must not raise
    assert reread.doc["entries"] == {}
    quarantined = path.with_name(path.name + ".corrupt")
    assert quarantined.exists()
    assert reg.counters == {"tune.store.corrupt": 1}
    assert [r["name"] for r in reg.records if r["kind"] == "event"] == \
        ["tune.store.quarantined"]
    # the rebuild path: next save writes a fresh well-formed table
    reread.doc["seq"] = 1
    reread.doc["entries"]["probe|8|dataflow|fuse=1|anchor=1|cpu"] = {
        "tiles": {"block_m": 8}, "us": 1.0, "default_us": 2.0, "seq": 1}
    reread.save()
    assert json.loads(path.read_text())["entries"]


def test_torn_write_leaves_partial_file_and_raises(tmp_path):
    path = tmp_path / "ckpt.json"
    doc = json.dumps({"step": 120, "shards": list(range(50))})
    with pytest.raises(chaos.ChaosWriteError):
        chaos.torn_write(path, doc, fail_after=20)
    assert path.stat().st_size == 20
    # a store pointed at the torn file recovers by quarantine
    reread = tune_store.TuningTable(path)
    assert reread.doc["entries"] == {}


def test_filesystem_helpers_match_reference(tmp_path):
    """truncate_file and corrupt_json leave the reference's bytes."""
    text = json.dumps({"a": list(range(40))})
    for helper, kw in ((chaos.truncate_file, {"fraction": 0.3}),
                       (chaos.truncate_file, {"keep": 7}),
                       (chaos.corrupt_json, {"seed": 5})):
        mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
        mine.write_text(text)
        ref.write_text(text)
        helper(mine, **kw)
        getattr(jchaos, helper.__name__)(ref, **kw)
        assert mine.read_bytes() == ref.read_bytes()


def test_jacobi_cell_operands_match_the_reference_drill():
    """The drill's Jacobi cell feeds D^-1 made by the port's own
    jacobi_dinv; it is the reference's to the bit."""
    a, b = guard_main._system()
    got = iterative.jacobi_dinv(_t(a), torch.float32).numpy()
    want = np.asarray(jiterative.jacobi_dinv(jnp.asarray(a), jnp.float32))
    np.testing.assert_array_equal(got, want)
    lp = LoopProgram(specs.JACOBI_LOOP, device=CPU)
    assert lp.lir.lspec.guards is not None


# -- verify diagnostics (RV5xx) ---------------------------------------------


# breakdown values may be scalars or vectors (per-right-hand-side
# sentinels like block-CG's Gram diagonal) but never matrices: the RV502
# row watches block-CG's (n, s) matvec panel; the RV504 row feeds a
# scalar back into block-CG's (n, s) iterate panel
@pytest.mark.parametrize("base,mutate,code", [
    ("cg", lambda it: it["guards"].__setitem__("bogus", {}), "RV500"),
    ("cg", lambda it: it["guards"].__setitem__("nonfinite",
                                               ["no_such_name"]), "RV501"),
    ("block_cg", lambda it: it["guards"].__setitem__(
        "breakdown", [{"value": "q", "below": 1e-30}]), "RV502"),
    ("cg", lambda it: it["guards"].__setitem__("divergence",
                                               {"factor": 0.5}), "RV503"),
    ("cg", lambda it: it["guards"].__setitem__("stagnation",
                                               {"window": 0}), "RV503"),
    ("block_cg", lambda it: it["feedback"].__setitem__(
        "x", it["while"]["metric"]), "RV504"),
])
def test_malformed_guards_get_rv5xx_diagnostics(base, mutate, code):
    """The reference's RV5xx cases (tests/test_guard.py), held to the
    reference's report: the same (code, severity, path) set."""
    from repro import verify as jverify
    from repro_torch import verify

    raw = copy.deepcopy(specs.CG_LOOP if base == "cg"
                        else specs.BLOCK_CG_LOOP)
    mutate(raw["iterate"])
    report = verify.analyze(copy.deepcopy(raw))
    assert any(d.code == code and d.severity == "error"
               for d in report.diagnostics), report.diagnostics
    assert {(d.code, d.severity, d.path) for d in report.diagnostics} == \
        {(d.code, d.severity, d.path)
         for d in jverify.analyze(copy.deepcopy(raw)).diagnostics}
    with pytest.raises(SpecError):
        lowering.lower_loop(raw, device=CPU)


def test_shipped_specs_verify_clean_with_guards():
    from repro_torch import verify

    for raw in (specs.CG_LOOP, specs.JACOBI_LOOP, specs.BICGSTAB_LOOP,
                specs.gmres_loop(8), specs.BLOCK_CG_LOOP):
        assert raw["iterate"].get("guards")
        report = verify.analyze(raw)
        assert not report.errors, (raw["name"], report.errors)
        assert not report.warnings, (raw["name"], report.warnings)
