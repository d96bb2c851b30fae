"""The GP predictive solve on the CPU: `blas.pivoted_cholesky`,
`blas.pcg` (`solvers.pcg.PCG_LOOP`) and `blas.solve(..., precond=)`
against the plain reference `solvers/plain_gp.py`, on seeded Matérn-3/2
kernel matrices K̂ = K + σ²I of n = 512 and 1,000 points in 8
dimensions (lengthscale 4, outputscale 1, σ² = 0.05, the benchmark
configuration's hyperparameters), preconditioner rank 15, tolerance
0.01; and the loop driver's spans and counter.

Tolerances: the kernel matrix within 1e-12 of a pair-by-pair float64
evaluation before its one rounding, and within half a float32 unit
after; L (float32, 15 greedy steps) within 1e-5 of the float64 factor
with the same pivots; the Woodbury application within 1e-4 relative of
a dense float64 (L Lᵀ + σ²I)⁻¹ r (float32 factors); PCG's iterations
equal to the plain float32 PCG's with the port's own factors, and
within 2 of the float64 reference's with its own factor, x within 1e-3
relative of the plain float32 PCG's: both stop at the same iteration
and differ only in float32 summation order, which each iteration
carries into x amplified by up to the condition number λmax/σ² (about
10⁴ at n = 1,000), so about 6e-4 at most; read 1.8e-5 and 1.6e-4. The
reported residual lies within 1e-4 ‖y‖ of the true one (float32
products; TF32 ones part them by about 2e-2 ‖y‖ at n = 512).
"""
import math
import time

import numpy as np
import pytest
import torch

from repro_torch import blas, obs
from repro_torch.guard import chaos, escalate
from repro_torch.solvers import pcg as pcg_mod, plain_gp

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

CPU = "cpu"
D, ELL, S2, NOISE, RANK, TOL = 8, 4.0, 1.0, 0.05, 15, 0.01
MODES = ("dataflow", "nodataflow", "reference")


def _system(n, seed):
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn(n, D, dtype=torch.float64, generator=gen)
    y = torch.randn(n, generator=gen)
    K = plain_gp.kernel_matrix(X, ELL, S2, NOISE)
    return X, K, y


@pytest.fixture(scope="module", params=[(512, 3), (1000, 2 ** 31 + 7)],
                ids=["n512", "n1000"])
def system(request):
    return _system(*request.param)


def test_kernel_matrix_is_matern32_plus_noise_rounded_once():
    X, K, _ = _system(64, 5)
    x = X.numpy()
    want = np.empty((64, 64))
    for i in range(64):
        for j in range(64):
            r = math.sqrt(((x[i] - x[j]) ** 2).sum())
            a = math.sqrt(3.0) * r / ELL
            want[i, j] = S2 * (1.0 + a) * math.exp(-a) + NOISE * (i == j)
    exact = plain_gp.matern32(X, X, ELL, S2) + NOISE * torch.eye(
        64, dtype=torch.float64)
    np.testing.assert_allclose(exact.numpy(), want, rtol=1e-12, atol=1e-12)
    assert K.dtype == torch.float32
    assert torch.equal(K, exact.to(torch.float32))
    assert torch.equal(K, K.T)
    assert torch.equal(K.diagonal(), torch.full((64,), S2 + NOISE))
    # row blocks of any height give the same matrix
    assert torch.equal(plain_gp.kernel_matrix(X, ELL, S2, NOISE, rows=7), K)


def test_pivoted_cholesky_matches_the_reference(system):
    _, K, _ = system
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    L64, pivots = plain_gp.pivoted_cholesky(K, RANK, NOISE)
    assert P.L.shape == P.W.shape == (K.shape[0], RANK)
    assert P.L.dtype == P.W.dtype == torch.float32 and P.rank == RANK
    assert P.pivots.tolist() == pivots
    assert float(P.shift) == pytest.approx(NOISE, rel=1e-7)
    np.testing.assert_allclose(P.L.numpy(), L64.numpy(), atol=1e-5)
    # the factor reproduces K − σ²I on its pivots' rows and columns
    Kp = (K.double() - NOISE * torch.eye(K.shape[0]))[pivots][:, pivots]
    Lp = L64[pivots]
    np.testing.assert_allclose((Lp @ Lp.T).numpy(), Kp.numpy(), atol=1e-10)
    np.testing.assert_allclose(
        P.W.numpy(), plain_gp.woodbury(L64, NOISE).numpy(), atol=1e-4)


def test_pivoted_cholesky_refuses_bad_arguments():
    _, K, _ = _system(32, 1)
    with pytest.raises(ValueError):
        blas.pivoted_cholesky(K[:, :16], RANK, NOISE)
    with pytest.raises(ValueError):
        blas.pivoted_cholesky(K, 0, NOISE)
    with pytest.raises(ValueError):
        blas.pivoted_cholesky(K, RANK, 0.0)


@pytest.mark.parametrize("mode", MODES)
def test_woodbury_apply_is_the_dense_inverse(system, mode):
    """`PCG_PRECOND` (the loop's preconditioner stage) and the plain
    reference's application against a dense float64 (L Lᵀ + σ²I)⁻¹ r."""
    _, K, y = system
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    L = P.L.double()
    dense = torch.linalg.solve(L @ L.T + NOISE * torch.eye(K.shape[0],
                                                          dtype=torch.float64),
                               y.double())
    scale = float(dense.norm())
    stage = blas.compile(pcg_mod.PCG_PRECOND, mode=mode, device=CPU).run(
        L=P.L, W=P.W, r=y, t0=P.L[0], inv_shift=1 / P.shift,
        neg_inv_shift=-1 / P.shift)
    for got in (stage["z"], plain_gp.precond_apply(P.L, P.W, NOISE, y)):
        assert float((got.double() - dense).norm()) <= 1e-4 * scale
    assert float(stage["rz"]) == pytest.approx(float(y.double() @ dense),
                                               rel=1e-4)
    exact = plain_gp.precond_apply(L, plain_gp.woodbury(L, NOISE), NOISE,
                                   y.double())
    assert float((exact - dense).norm()) <= 1e-10 * scale


@pytest.mark.parametrize("mode", MODES)
def test_pcg_matches_the_plain_reference(system, mode):
    _, K, y = system
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    res = blas.pcg(K, y, precond=P, tol=TOL, max_iters=1000, mode=mode,
                   device=CPU)
    assert res.status_names() == "CONVERGED"
    x32, it32, r32 = plain_gp.pcg(K, y[:, None], P.L, P.W, NOISE, tol=TOL,
                                  max_iters=1000)
    assert int(res.iterations) == int(it32[0])
    assert float((res.x - x32[:, 0]).norm()) <= 1e-3 * float(x32.norm())
    L64, _ = plain_gp.pivoted_cholesky(K, RANK, NOISE)
    _, it64, _ = plain_gp.pcg(K, y[:, None].double(), L64,
                              plain_gp.woodbury(L64, NOISE), NOISE,
                              tol=TOL, max_iters=1000)
    assert abs(int(res.iterations) - int(it64[0])) <= 2
    ynorm = float(y.double().norm())
    true = float((plain_gp.matmul(K, res.x) - y.double()).norm())
    assert float(res.residual) <= TOL * ynorm
    assert true <= 1.01 * TOL * ynorm
    # the recurrence's residual stays by the true one (float32 products)
    assert abs(float(res.residual) - true) <= 1e-4 * ynorm
    # the preconditioner does its work: plain CG needs more iterations
    cg = blas.cg(K, y, tol=TOL, max_iters=1000, mode=mode, device=CPU)
    assert int(cg.iterations) > int(res.iterations)


@pytest.mark.parametrize("mode", MODES)
def test_solve_with_precond_runs_pcg_first(system, mode):
    _, K, y = system
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    got = blas.solve(K, y, tol=TOL, max_iters=1000, precond=P, mode=mode,
                     device=CPU)
    assert [(a.solver, a.action) for a in got.attempts] == \
        [("pcg", "initial")]
    direct = blas.pcg(K, y, precond=P, tol=TOL, max_iters=1000, mode=mode,
                      device=CPU)
    assert torch.equal(got.x, direct.x)
    assert got.attempts[0].iterations == int(direct.iterations)


def test_solve_without_precond_is_unchanged(system):
    _, K, y = system
    got = blas.solve(K, y, tol=TOL, max_iters=1000, device=CPU)
    assert [(a.solver, a.action) for a in got.attempts] == \
        [("cg", "initial")]
    want = blas.cg(K, y, tol=TOL, max_iters=1000, device=CPU)
    assert torch.equal(got.x, want.x)
    assert int(got.iterations) == int(want.iterations)


def test_ladder_leaves_pcg_on_a_planted_fault():
    _, K, y = _system(512, 3)
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    plan = chaos.FaultPlan(program="pcg", kind="nan", output="z",
                           iteration=2)
    got = blas.solve(K, y, tol=TOL, max_iters=1000, precond=P, device=CPU,
                     fault=plan)
    assert [(a.solver, a.action, a.status_name) for a in got.attempts] == \
        [("pcg", "initial", "NONFINITE"), ("pcg", "retry", "CONVERGED")]
    policy = blas.EscalationPolicy(chain=("pcg", "cg"),
                                   retry_restart=False)
    got = blas.solve(K, y, tol=TOL, max_iters=1000, precond=P, device=CPU,
                     fault=plan, policy=policy)
    assert [(a.solver, a.action, a.status_name) for a in got.attempts] == \
        [("pcg", "initial", "NONFINITE"), ("cg", "switch", "CONVERGED")]
    true = plain_gp.matmul(K, got.x) - y.double()
    assert float(true.norm()) <= 1.01 * TOL * float(y.double().norm())


def test_ladder_refuses_pcg_without_a_preconditioner():
    _, K, y = _system(64, 4)
    P = blas.pivoted_cholesky(K, 4, NOISE)
    with pytest.raises(ValueError, match="preconditioner"):
        blas.solve(K, y, device=CPU,
                   policy=blas.EscalationPolicy(chain=("pcg",)))
    with pytest.raises(ValueError, match="panel"):
        blas.solve(K, torch.stack([y, y], 1), device=CPU, precond=P)
    assert escalate.PRECOND_CHAIN == ("pcg", "cg", "bicgstab", "gmres")


# ---------------------------------------------------------------------------
# The loop driver's spans and counter
# ---------------------------------------------------------------------------


def _solve_recorded(wait):
    _, K, y = _system(512, 3)
    with obs.capture(wait=wait) as reg:
        P = blas.pivoted_cholesky(K, RANK, NOISE)
        res = blas.pcg(K, y, precond=P, tol=TOL, max_iters=1000, device=CPU)
    spans = [r for r in reg.records if r["kind"] == "span"]
    return res, spans, dict(reg.counters)


def test_loop_spans_have_the_right_parents():
    res, spans, counters = _solve_recorded(wait=False)
    by_id = {r["id"]: r for r in spans}
    solve, = [r for r in spans if r["name"] == "solver.solve"]
    build, = [r for r in spans if r["name"] == "precond.build"]
    assert build["parent"] is None and build["attrs"]["rank"] == RANK
    iters = [r for r in spans if r["name"] == "loop.iter"]
    stops = [r for r in spans if r["name"] == "loop.stop"]
    stages = [r for r in spans if r["name"] == "loop.stage"]
    k = int(res.iterations)
    # one iteration span a solve's iteration, each with its stop read
    assert len(iters) == len(stops) == k > 0
    assert counters["loop.iterations"] == k
    assert all(r["parent"] == solve["id"] for r in iters)
    assert all(by_id[r["parent"]]["name"] == "loop.iter" for r in stops)
    assert sorted(r["parent"] for r in stops) == \
        sorted(r["id"] for r in iters)
    assert torch.isnan(res.history[k + 1:]).all()
    assert not torch.isnan(res.history[:k + 1]).any()
    lir = blas.solvers._EXECUTABLES[
        ("loop", "pcg", (), "dataflow", CPU, 1000)]._impl.lir
    setup = [r for r in stages if r["parent"] == solve["id"]]
    body = [r for r in stages if r["parent"] != solve["id"]]
    assert [r["attrs"]["stage"] for r in setup] == [
        cs.ir.spec.name if cs.tag == "program" else cs.tag
        for cs in lir.setup]
    assert [r["attrs"]["stage"] for r in setup] == [
        "nrm2", "residual", "read", "let", "pcg_precond"]
    assert [r["attrs"]["stage"] for r in body[:6]] == [
        "cg_matvec", "let", "cg_update", "pcg_precond", "let", "cg_pupdate"]
    assert len(body) == 6 * k
    assert all(by_id[r["parent"]]["name"] == "loop.iter" for r in body)
    for r in stages + iters + stops:
        up = by_id[r["parent"]]
        assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
            up["end_ns"]
        assert r["attrs"]["program"] == "pcg"
    groups = [r for r in spans if r["name"] == "kernel.group"]
    assert all(by_id[r["parent"]]["name"] == "loop.stage" for r in groups)


def test_no_host_read_in_an_iteration_but_the_stop(monkeypatch):
    """Under `capture(wait=False)` nothing blocks, and every read of a
    tensor's value on the host inside a `loop.iter` span lies inside
    its `loop.stop` span: the stop rule's read is the iteration's one."""
    def refuse(values):
        raise AssertionError("a site waited for the device")
    monkeypatch.setattr(obs, "block", refuse)
    reads = []
    for name in ("__int__", "__bool__", "__float__", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *args, _real=real, **kw):
            reads.append(time.time_ns())
            return _real(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    res, spans, _ = _solve_recorded(wait=False)
    monkeypatch.undo()
    iters = [(r["start_ns"], r["end_ns"]) for r in spans
             if r["name"] == "loop.iter"]
    stops = [(r["start_ns"], r["end_ns"]) for r in spans
             if r["name"] == "loop.stop"]
    inside = [t for t in reads if any(a <= t <= b for a, b in iters)]
    assert len(inside) >= int(res.iterations)
    assert all(any(a <= t <= b for a, b in stops) for t in inside)


def test_recording_off_records_nothing_and_keeps_the_bits():
    _, K, y = _system(512, 3)
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    off = blas.pcg(K, y, precond=P, tol=TOL, device=CPU)
    assert obs.records() == [] and obs.counters() == {}
    assert obs.span_with("loop.iter") is obs.NULL_SPAN
    with obs.capture(wait=False):
        on = blas.pcg(K, y, precond=P, tol=TOL, device=CPU)
    assert torch.equal(on.x, off.x)
    assert int(on.iterations) == int(off.iterations)
    assert obs.records() == [] and obs.counters() == {}


def test_plain_solver_program_records_iterations():
    """The class-based solvers' ungated loop takes the same `loop.iter`
    and `loop.stop` spans and counter (it has no stages)."""
    from repro_torch.solvers import iterative

    _, K, y = _system(64, 4)
    solver = iterative.CG(mode="dataflow", device=CPU, max_iters=200)
    with obs.capture(wait=False) as reg:
        res = solver.solve(K, y, tol=1e-4)
    names = [r["name"] for r in reg.records if r["kind"] == "span"]
    assert names.count("loop.iter") == names.count("loop.stop") == \
        int(res.iterations) > 0
    assert reg.counters["loop.iterations"] == int(res.iterations)


def test_pcg_spec_is_built_from_registry_routines():
    from repro_torch.core import routines as R

    names = {r["blas"] for r in pcg_mod.PCG_PRECOND["routines"]}
    assert names == {"gemvt", "gemv", "dot"} <= set(R.names())
    guards = pcg_mod.PCG_LOOP["iterate"]["guards"]
    cg = blas.solvers.specs.CG_LOOP["iterate"]["guards"]
    assert {k: v for k, v in guards.items() if k != "stagnation"} == \
        {k: v for k, v in cg.items() if k != "stagnation"}
    assert guards["stagnation"]["window"] == 200 > \
        cg["stagnation"]["window"]


@pytest.mark.parametrize("case", ["converges", "max_iters", "fault"])
def test_pcg_loop_stops_where_its_status_says(case):
    """The guarded loop reads each iteration's status and stops there:
    a solve that converges, runs out of iterations or meets a planted
    fault returns that status, its iterations, and a history finite up
    to them and NaN past them."""
    from repro_torch.solvers import LoopProgram

    _, K, y = _system(512, 3)
    P = blas.pivoted_cholesky(K, RANK, NOISE)
    fault = chaos.FaultPlan(program="pcg", kind="nan", output="z",
                            iteration=4) if case == "fault" else None
    lp = LoopProgram(pcg_mod.PCG_LOOP, device=CPU, fault=fault,
                     max_iters=7 if case == "max_iters" else 1000)
    res = lp.solve(tol=TOL, A=K, b=y, x0=torch.zeros_like(y),
                   **P.operands())
    k = int(res.iterations)
    assert res.status_names() == {
        "converges": "CONVERGED", "max_iters": "MAX_ITERS",
        "fault": "NONFINITE"}[case]
    if case == "max_iters":
        assert k == 7
    elif case == "fault":
        # z goes NaN in iteration 4 (counted from 0), p with it, and the
        # guard on x' trips in the iteration after
        assert k == 6
    else:
        assert 7 < k < 1000
    assert torch.isnan(res.history[k + 1:]).all()
    if case != "fault":
        assert torch.isfinite(res.history[:k + 1]).all()
