"""Port parity for the class-based solvers (`repro_torch/solvers/
iterative.py`): `CG`, `BiCGStab`, `Jacobi` and `PowerIteration` and
their function forms against the reference's classes
(`repro/solvers/iterative.py`), on the CPU, on the same seeded numpy
operands, in dataflow, nodataflow and reference mode. Mirrors
tests/test_solvers.py and the class halves of tests/test_loop_program.py.

What must agree with the reference: the iteration count and the status
exactly; x within rtol 1e-5 and atol 1e-6 (of max(1, |x|max)); the
residual history within rtol 1e-4 and atol 1e-6 of its scale (float32
recurrences summed in another order drift apart by a few ulps an
iteration), PowerIteration's inf at index 0 compared as inf; the
eigenvalue within rtol 1e-5. Against the port's own loop specs, which
run the same stage programs with the same scalar expressions, x and the
history are held bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solvers import (BiCGStab as JBiCGStab, CG as JCG,
                           Jacobi as JJacobi,
                           PowerIteration as JPowerIteration)
from repro_torch.core.runtime import inputs_from_numpy
from repro_torch.solvers import (BiCGStab, CG, Jacobi, LoopProgram,
                                 PowerIteration, bicgstab, cg, driver,
                                 iterative, jacobi, power_iteration,
                                 specs)

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(n, seed=0):
    m = _rng(seed).standard_normal((n, n))
    return (m @ m.T / n + np.eye(n)).astype(np.float32)


def _diag_dominant(n, seed=0):
    a = _spd(n, seed)
    return (a + 2.0 * np.diag(np.abs(a).sum(axis=1))).astype(np.float32)


def _nonsym(n, seed=3):
    a = _rng(seed).standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    return a.astype(np.float32)


def _gapped(n, seed=5):
    """A symmetric matrix with eigenvalues 10, 3 and the rest in [0.5,
    2.5]: power iteration's metric falls by about (3/10)^2 an iteration,
    so no step lands near the stop threshold."""
    q, _ = np.linalg.qr(_rng(seed).standard_normal((n, n)))
    lam = np.concatenate([[10.0, 3.0], _rng(seed + 1).uniform(0.5, 2.5,
                                                              n - 2)])
    return ((q * lam) @ q.T).astype(np.float32)


def _rhs(n, seed=1):
    return _rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


_JCLS = {CG: JCG, BiCGStab: JBiCGStab, Jacobi: JJacobi,
         PowerIteration: JPowerIteration}
_REFERENCE: dict = {}


def _reference(cls, mode, ops, tol, **kw):
    """The reference class's result, solved once per case for the
    module."""
    key = (cls.__name__, mode, tol, tuple(sorted(kw.items())),
           tuple(np.asarray(v).tobytes() for v in ops))
    if key not in _REFERENCE:
        solver = _JCLS[cls](mode=mode, **kw)
        _REFERENCE[key] = solver.solve(*(jnp.asarray(v) for v in ops),
                                       tol=tol)
    return _REFERENCE[key]


def _port(cls, mode, ops, tol, **kw):
    solver = cls(mode=mode, device="cpu", **kw)
    return solver, solver.solve(*(_t(v) for v in ops), tol=tol)


def _assert_history(hist, whist):
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(whist))
    np.testing.assert_array_equal(np.isinf(hist), np.isinf(whist))
    finite = np.isfinite(whist)
    scale = float(np.abs(whist[finite]).max()) if finite.any() else 1.0
    np.testing.assert_allclose(hist[finite], whist[finite], rtol=1e-4,
                               atol=1e-6 * scale)


def _assert_same_solve(got, want):
    assert int(got.iterations) == int(want.iterations)
    assert got.status_names() == want.status_names()
    assert bool(got.converged) == bool(want.converged)
    _assert_history(got.history.numpy(), np.asarray(want.history))
    x, wx = got.x.numpy(), np.asarray(want.x)
    assert x.shape == wx.shape and x.dtype == np.float32
    np.testing.assert_allclose(
        x, wx, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(wx).max())))


def _system(cls, n=64):
    if cls is Jacobi:
        return _diag_dominant(n), _rhs(n)
    if cls is BiCGStab:
        return _nonsym(n), _rhs(n)
    return _spd(n), _rhs(n)


# ---------------------------------------------------------------------------
# Parity with the reference's classes, in every mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cls", [CG, BiCGStab, Jacobi])
def test_linear_solver_matches_reference(cls, mode):
    ops = _system(cls)
    solver, got = _port(cls, mode, ops, 1e-6, max_iters=100)
    want = _reference(cls, mode, ops, 1e-6, max_iters=100)
    assert got.status_names() == "CONVERGED"
    _assert_same_solve(got, want)
    assert got.iterations.dtype == torch.int32
    assert got.status.dtype == torch.int8
    assert solver.trace_count == 1


@pytest.mark.parametrize("mode", MODES)
def test_power_iteration_matches_reference(mode):
    A = _gapped(96)
    solver, got = _port(PowerIteration, mode, (A,), 1e-6, max_iters=200)
    want = _reference(PowerIteration, mode, (A,), 1e-6, max_iters=200)
    assert got.status_names() == "CONVERGED"
    _assert_same_solve(got, want)
    assert np.isinf(got.history.numpy()[0])
    np.testing.assert_allclose(float(got.aux["eigenvalue"]),
                               float(want.aux["eigenvalue"]), rtol=1e-5)


@pytest.mark.parametrize("omega,richardson", [(0.8, False), (0.3, True)])
def test_jacobi_omega_and_richardson_match_reference(omega, richardson):
    A = _spd(64) if richardson else _diag_dominant(64)
    ops = (A, _rhs(64))
    kw = dict(omega=omega, richardson=richardson, max_iters=300)
    _, got = _port(Jacobi, "dataflow", ops, 1e-6, **kw)
    want = _reference(Jacobi, "dataflow", ops, 1e-6, **kw)
    assert got.status_names() == "CONVERGED"
    _assert_same_solve(got, want)


def test_jacobi_dinv_matches_reference():
    from repro.solvers.iterative import jacobi_dinv as jjacobi_dinv
    a = _diag_dominant(32)
    a[3, 3] = 0.0                      # a zero diagonal passes through
    got = iterative.jacobi_dinv(_t(a))
    want = np.asarray(jjacobi_dinv(jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[3]) == 1.0
    assert iterative.jacobi_dinv(_t(a), torch.bfloat16).dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# Convergence against numpy (tests/test_solvers.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 200])
def test_cg_solves_random_spd(n):
    A, b = _spd(n), _rhs(n)
    res = cg(_t(A), _t(b), tol=1e-6, max_iters=300, device="cpu")
    assert bool(res.converged)
    x = res.x.double().numpy()
    relres = np.linalg.norm(b - A.astype(np.float64) @ x) / np.linalg.norm(b)
    assert relres <= 1e-5, relres
    np.testing.assert_allclose(x, np.linalg.solve(A.astype(np.float64), b),
                               rtol=1e-4, atol=1e-4)


def test_bicgstab_solves_nonsymmetric():
    n = 128
    A, b = _nonsym(n), _rhs(n)
    res = BiCGStab(max_iters=300, device="cpu").solve(_t(A), _t(b),
                                                      tol=1e-7)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               rtol=1e-3, atol=1e-4)


def test_jacobi_converges_on_diag_dominant():
    n = 128
    A, b = _diag_dominant(n), _rhs(n)
    res = jacobi(_t(A), _t(b), tol=1e-6, max_iters=500, device="cpu")
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               rtol=1e-4, atol=1e-5)
    # the reported residual belongs to the returned iterate: within 10%
    # of its float64 residual (the float32 one carries rounding of a few
    # percent at 2e-6), while the iterate before it had about 10x more
    true = np.linalg.norm(b - A.astype(np.float64) @ res.x.double().numpy())
    np.testing.assert_allclose(float(res.residual), true, rtol=0.1)
    assert res.history_trimmed()[-2] > 3 * true


def test_power_iteration_finds_dominant_eigenpair():
    A = _spd(128)
    res = power_iteration(_t(A), tol=1e-9, max_iters=2000, device="cpu")
    lam = float(res.aux["eigenvalue"])
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(A)[-1], rtol=1e-4)
    v = res.x.numpy()
    assert np.linalg.norm(A @ v - lam * v) < 1e-2


# ---------------------------------------------------------------------------
# Mode parity, stopping and telemetry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [CG, BiCGStab, Jacobi])
def test_linear_solver_mode_parity(cls):
    A, b = _system(cls, 200)
    results = {m: cls(mode=m, max_iters=100, device="cpu").solve(
        _t(A), _t(b), tol=1e-7) for m in ("dataflow", "nodataflow")}
    df, nodf = results["dataflow"], results["nodataflow"]
    assert int(df.iterations) == int(nodf.iterations)
    np.testing.assert_allclose(df.x.numpy(), nodf.x.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(df.history.numpy(), nodf.history.numpy(),
                               rtol=1e-3, atol=1e-5)


def test_early_stop_on_max_iters():
    A, b = _spd(128), _rhs(128)
    res = CG(max_iters=3, device="cpu").solve(_t(A), _t(b), tol=1e-12)
    assert int(res.iterations) == 3
    assert not bool(res.converged)
    assert res.status_names() == "MAX_ITERS"


def test_stops_before_max_iters_on_tolerance():
    A, b = _spd(128), _rhs(128)
    res = CG(max_iters=200, device="cpu").solve(_t(A), _t(b), tol=1e-5)
    assert bool(res.converged)
    assert int(res.iterations) < 200


def test_zero_rhs_converges_instantly():
    A = _spd(64)
    res = CG(max_iters=50, device="cpu").solve(_t(A), torch.zeros(64),
                                               tol=1e-6)
    assert int(res.iterations) == 0
    assert bool(res.converged)
    np.testing.assert_array_equal(res.x.numpy(), np.zeros(64))


def test_residual_history_telemetry():
    A, b = _spd(128), _rhs(128)
    res = CG(max_iters=100, device="cpu").solve(_t(A), _t(b), tol=1e-6)
    k = int(res.iterations)
    hist = res.history.numpy()
    assert hist.shape == (101,)
    assert np.all(np.isfinite(hist[:k + 1]))
    assert np.all(np.isnan(hist[k + 1:]))
    np.testing.assert_allclose(hist[0], np.linalg.norm(b), rtol=1e-5)
    np.testing.assert_allclose(hist[k], float(res.residual), rtol=1e-6)
    assert hist[k] < 1e-3 * hist[0]
    np.testing.assert_array_equal(res.history_trimmed(), hist[:k + 1])


@pytest.mark.parametrize("cls", [CG, BiCGStab, Jacobi])
def test_solve_is_assembled_once(cls):
    """The port assembles a solver's solve once, however many solves and
    shapes follow (the reference traces once per shape)."""
    A, b = _system(cls, 96)
    solver = cls(max_iters=50, device="cpu")
    solver.solve(_t(A), _t(b), tol=1e-6)
    assert solver.trace_count == 1
    solver.solve(_t(A + 0.1 * np.eye(96, dtype=np.float32)), _t(b * 2.0),
                 tol=1e-4)
    assert solver.trace_count == 1
    A2, b2 = _system(cls, 48)
    assert bool(solver.solve(_t(A2), _t(b2), tol=1e-6).converged)
    assert solver.trace_count == 1


def test_solver_describe_lists_fused_groups():
    desc = CG(mode="dataflow", device="cpu").describe()
    assert desc.startswith("solver 'cg' mode=dataflow max_iters=200")
    assert "FUSED on-chip group" in desc
    assert "cg_update" in desc
    assert "FUSED" not in CG(mode="nodataflow", device="cpu").describe()


# ---------------------------------------------------------------------------
# Class halves of tests/test_loop_program.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cls,loop", [(CG, "CG_LOOP"),
                                      (Jacobi, "JACOBI_LOOP"),
                                      (BiCGStab, "BICGSTAB_LOOP")])
def test_loop_spec_matches_class_bitwise(cls, loop, mode):
    """The loop spec and the class run the same stage programs with the
    same scalar expressions: the same iterations and status, and x and
    the history bitwise."""
    A, b = _system(cls)
    ops = {"A": A, "b": b, "x0": np.zeros_like(b)}
    if cls is Jacobi:
        ops.update(dinv=iterative.jacobi_dinv(_t(A)).numpy(),
                   omega=np.float32(1.0))
    got = LoopProgram(getattr(specs, loop), mode=mode, max_iters=100,
                      device="cpu").solve(
        tol=1e-6, **inputs_from_numpy(ops, device="cpu"))
    want = cls(mode=mode, max_iters=100, device="cpu").solve(
        _t(A), _t(b), tol=1e-6)
    assert int(got.iterations) == int(want.iterations)
    assert got.status_names() == want.status_names() == "CONVERGED"
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.history.nan_to_num(-1.0),
                       want.history.nan_to_num(-1.0))


def test_bicgstab_s_early_exit_on_identity():
    """On A = I the first half-step is exact: s = 0, so the step takes
    the early branch (x += alpha p, no second matvec) and the loop stops
    after one iteration, in both packages."""
    n = 48
    b = _rhs(n)
    want = JBiCGStab(max_iters=50).solve(jnp.eye(n), jnp.asarray(b),
                                         tol=1e-6)
    assert int(want.iterations) == 1 and bool(want.converged)
    solver = BiCGStab(max_iters=50, device="cpu")
    full = []
    solver._mv2 = lambda **kw: full.append(kw)   # the full branch's matvec
    got = solver.solve(torch.eye(n), _t(b), tol=1e-6)
    assert full == []
    assert int(got.iterations) == 1 and bool(got.converged)
    np.testing.assert_allclose(got.x.numpy(), b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_bicgstab_still_converges_with_early_exit(mode):
    n = 96
    A, b = _nonsym(n), _rhs(n)
    res = BiCGStab(mode=mode, max_iters=300, device="cpu").solve(
        _t(A), _t(b), tol=1e-7)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("cls", [CG, BiCGStab, Jacobi])
def test_solve_batched_matches_reference(cls):
    """`solve_batched` against the reference's vmapped one on three
    right-hand sides, and each lane bitwise the port's own solve of
    that row (tests/test_loop_program.py:181)."""
    A, _ = _system(cls, 48)
    B = np.stack([_rhs(48, s) for s in range(7, 10)])
    got = cls(device="cpu", max_iters=100).solve_batched(_t(A), _t(B),
                                                         tol=1e-6)
    want = _JCLS[cls](max_iters=100).solve_batched(
        jnp.asarray(A), jnp.asarray(B), tol=1e-6)
    assert got.x.shape == B.shape and got.history.shape == (3, 101)
    assert got.status_names() == ["CONVERGED"] * 3
    for i in range(3):
        lane = driver.SolverResult(
            x=got.x[i], iterations=got.iterations[i],
            residual=got.residual[i], history=got.history[i],
            converged=got.converged[i], status=got.status[i])
        _assert_same_solve(lane, type(want)(
            x=want.x[i], iterations=want.iterations[i],
            residual=want.residual[i], history=want.history[i],
            converged=want.converged[i], status=want.status[i]))
        single = cls(device="cpu", max_iters=100).solve(
            _t(A), _t(B[i]), tol=1e-6)
        assert int(single.iterations) == int(got.iterations[i])
        assert torch.equal(single.x, got.x[i])


def test_solve_batched_takes_x0_rows():
    """X0's rows start their lanes; a lane started at its solution
    stops before its first iteration."""
    A, _ = _system(CG, 32)
    B = np.stack([_rhs(32, s) for s in (1, 2)])
    X0 = np.stack([np.zeros(32, np.float32),
                   np.linalg.solve(A, B[1]).astype(np.float32)])
    got = CG(device="cpu").solve_batched(_t(A), _t(B), _t(X0), tol=1e-3)
    want = JCG().solve_batched(jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(X0), tol=1e-3)
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert int(got.iterations[1]) == 0 and int(got.iterations[0]) > 0


# ---------------------------------------------------------------------------
# Function forms, devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,cls", [(cg, CG), (bicgstab, BiCGStab),
                                    (jacobi, Jacobi)])
def test_functions_match_their_classes(fn, cls):
    A, b = _system(cls)
    got = fn(_t(A), _t(b), tol=1e-6, max_iters=100, device="cpu")
    want = cls(max_iters=100, device="cpu").solve(_t(A), _t(b), tol=1e-6)
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)


def test_power_iteration_function_matches_class_and_start():
    A = _gapped(64)
    got = power_iteration(_t(A), tol=1e-6, max_iters=200, device="cpu")
    v0 = torch.cos(torch.arange(64, dtype=torch.float32) * 0.7) + 0.1
    want = PowerIteration(max_iters=200, device="cpu").solve(_t(A), v0,
                                                             tol=1e-6)
    assert int(got.iterations) == int(want.iterations)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.aux["eigenvalue"], want.aux["eigenvalue"])


@pytest.mark.parametrize("cls", [CG, BiCGStab, Jacobi, PowerIteration])
def test_solver_needs_a_card_unless_given_the_cpu(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()
    assert cls(device="cpu").device == torch.device("cpu")
