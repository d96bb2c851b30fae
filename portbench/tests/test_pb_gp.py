"""The GP solve cell (`gp-predict-pcg`) at a size a test run holds: its
configuration, a whole run on the CPU, both controls and a solve that
leaves the first rung coming out not correct, the work it reckons, the
loop window's arithmetic on a made-up trace, and what its reference
imports."""
import json
import pathlib
import sys
import time

import pytest
import torch

from portbench import core, gp_work, manifest as mf, solve_spans

from .test_pb_manifest import _imports

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "gp-predict-pcg"
# n = 512, with limits set from readings at that size (the cell's are
# set at n = 65,536): the program's gap 4.9e-6 and iterations off by 2,
# the TF32 control's gap 2.0e-2, plain CG's iterations off by 19
TINY = ({"n": 512, "limits": {"relres_true_max": 0.0105,
                              "resid_gap_max": 1e-4, "iters_off_max": 8}},
        {"rhs_pool": 4, "warm_solves": 1})
SEED = 2 ** 31 + 23


def _run(trace=0, seconds=0.3, setup=None, seed=SEED):
    run = core.prepare(CELL, seed, seconds, trace, "cpu",
                       config_overrides=TINY[0], traffic_overrides=TINY[1])
    if setup is not None:
        setup(run)
    return core.execute(run, time.perf_counter())


def test_the_configuration_loads():
    m = mf.load(ROOT)
    cell = mf.cell(m, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "solve-stream"
    entry, = [c for c in m["configs"] if c["name"] == cell["config"]]
    assert entry["reduced"] == []
    cfg = mf.config(m, cell["config"], ROOT)
    assert cfg["name"] == entry["name"] == "gp-matern32-65536"
    assert cfg["source"] == entry["source"]
    assert (cfg["n"], cfg["d"], cfg["precond_rank"], cfg["tol"],
            cfg["max_iters"]) == (65536, 8, 15, 0.01, 1000)
    assert (cfg["lengthscale"], cfg["outputscale"], cfg["noise"],
            cfg["nu"], cfg["data_seed"]) == (4.0, 1.0, 0.05, 1.5, 0)
    assert set(cfg["limits"]) == set(cfg["limit_reasons"]) == {
        "relres_true_max", "resid_gap_max", "iters_off_max"}
    assert {"d", "X", "lengthscale", "outputscale", "noise", "n",
            "rhs"} <= set(cfg["assumed"])
    traffic = mf.traffic(cell["traffic"])
    assert traffic["driver"] == "solve" and traffic["rhs_pool"] == 64
    ours = [p for p in m["per_layer"] if p.get("workloads") == [CELL]]
    assert {p["name"] for p in ours} == {
        "kernel_roofline.solve", "iters_per_solve.solve",
        "iter_issue_us.solve", "idle_per_iter_us.solve",
        "kernels_per_iter.solve", "precond_share.solve"}
    assert all(p["moves"] == "calls_per_s" for p in ours)
    calls, = [e for e in m["end_to_end"] if e["name"] == "calls_per_s"]
    assert CELL in calls["workloads"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_is_correct(trace, store):
    line = _run(trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {"iters_per_solve.solve", "iter_issue_us.solve"} if trace \
        else {"calls_per_s", "setup_s"}
    assert want <= set(line["metrics"])
    checks = line["checks"]
    assert checks["relres_true_max"]["value"] <= 0.0101
    assert checks["resid_gap_max"]["value"] < 1e-4
    json.dumps(line)


@pytest.mark.parametrize("kind,fails", [("tf32", "resid_gap_max"),
                                        ("cg", "iters_off_max")])
def test_each_control_is_not_correct(kind, fails, monkeypatch, store):
    line = _run(setup=lambda run: run.system.use_control(
        monkeypatch.setattr, kind=kind))
    assert line["correct"] is False
    assert line["attempted"] > 0
    c = line["checks"][fails]
    assert c["value"] > c["limit"], line["checks"]


def test_a_solve_that_leaves_the_first_rung_fails(monkeypatch, store):
    from repro_torch.guard import chaos

    plan = chaos.FaultPlan(program="pcg", kind="nan", output="z",
                           iteration=1)

    def make(solve):
        def faulted(*args, **kw):
            return solve(*args, fault=plan, **kw)
        return faulted
    line = _run(setup=lambda run: run.system.replace_solve(
        make, monkeypatch.setattr))
    assert line["correct"] is False
    assert line["failed"] > 0 and line["attempted"] == 0


def test_the_dataset_is_fixed_and_the_traffic_follows_the_seed():
    runs = []
    for seed in (SEED, SEED + 1, SEED):
        run = core.prepare(CELL, seed, 0.1, 0, "cpu",
                           config_overrides=TINY[0],
                           traffic_overrides=TINY[1])
        run.system.build(run)
        runs.append(run.inputs)
    assert torch.equal(runs[0]["K"], runs[1]["K"])
    assert torch.equal(runs[0]["precond"].L, runs[1]["precond"].L)
    assert not torch.equal(runs[0]["Y"], runs[1]["Y"])
    assert torch.equal(runs[0]["Y"], runs[2]["Y"])


def test_a_program_without_the_preconditioner_fails_at_once(monkeypatch):
    from repro_torch import blas

    monkeypatch.delattr(blas, "pivoted_cholesky")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="pivoted_cholesky"):
        _run()
    assert time.perf_counter() - t0 < 5.0


def test_the_work_of_an_iteration():
    n, k = 65536, 15
    assert gp_work.iteration_bytes(n, k) == \
        4 * 65536 ** 2 + 7_864_320 + 1_572_864 == 17_189_306_368
    assert gp_work.solve_work(n, k, 129) == (
        130 * 17_189_306_368, 130 * gp_work.iteration_flops(n, k))
    assert gp_work.iteration_flops(n, k) == \
        2 * n * n + 4 * n * k + 10 * n


def test_the_reference_imports_nothing_of_the_program():
    bench = ROOT / "portbench"
    for path in (bench / "gp_reference.py", bench / "gp_work.py",
                 ROOT / "src/repro_torch/solvers/plain_gp.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= set(sys.stdlib_module_names) | {"torch"}, \
            (path, tops)
    tops = {n.split(".")[0] for n in _imports(bench / "systems/gp_solve.py")}
    assert "repro" not in tops and "jax" not in tops


def _window(events, correlation, spans, attrs, iterations=2):
    return solve_spans.SolveWindow(core.Window(calls=1), events,
                                   correlation, spans, attrs,
                                   {"loop.iterations": iterations})


def test_the_loop_window_arithmetic():
    """Two iterations on a made-up trace: each `loop.iter` holds two
    stages and a stop; the preconditioner's stage launches one kernel,
    the other stage another. Numbers in ns."""
    spans = [
        ("solver.solve", 1, None, 0, 1000),
        ("loop.iter", 2, 1, 100, 500), ("loop.stage", 3, 2, 110, 200),
        ("loop.stage", 4, 2, 210, 300), ("loop.stop", 5, 2, 400, 500),
        ("loop.iter", 6, 1, 500, 900), ("loop.stage", 7, 6, 510, 600),
        ("loop.stage", 8, 6, 610, 700), ("loop.stop", 9, 6, 800, 900),
    ]
    attrs = {sid: {"stage": "pcg_precond" if sid in (4, 8) else "x"}
             for _, sid, _, _, _ in spans}
    events = [
        ("cudaLaunchKernel", False, 120, 130), ("mv", True, 130, 390),
        ("cuLaunchKernel", False, 220, 230), ("precond", True, 390, 420),
        ("cudaLaunchKernel", False, 520, 530), ("mv", True, 530, 790),
        ("cuLaunchKernel", False, 620, 630), ("precond", True, 790, 820),
        ("Memcpy DtoH", True, 820, 830),
    ]
    corr = [1, 1, 2, 2, 3, 3, 4, 4, 0]
    w = _window(events, corr, spans, attrs)
    assert solve_spans.busy_ns(w) == 290 + 290 + 10
    assert solve_spans.precond_device_ns(w) == 60
    from portbench import spantrace
    own = spantrace.self_ns(w.spans)
    assert [own[s] for s in (2, 6)] == [400 - 90 - 90 - 100] * 2
    # the trace's gaps [120, 130) and [420, 530) each lie inside an
    # iteration by their middles (125, 475)
    assert spantrace.idle_under(w.events, w.spans, "loop.iter") == \
        10 + 110
    # no launch inside the preconditioner's spans: nothing to read
    none = dict(attrs)
    none.update({4: {"stage": "x"}, 8: {"stage": "x"}})
    assert solve_spans.precond_device_ns(
        _window(events, corr, spans, none)) is None

