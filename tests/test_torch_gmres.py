"""Port parity for GMRES(m) and the loop grammar it needs: stack state,
`read` and `store` stages and nested `iterate` loops, in the port's loop
lowering (`core/lowering.py`) and driver (`solvers/driver.py`), against
the reference's `repro.solvers.LoopProgram` on the CPU. The same seeded
numpy operands and the same spec dicts (the port's copies, held equal
to the reference's in tests/test_torch_loop.py) go through both; the
port's stage programs run their plain versions, the reference's its
Pallas kernels in interpret mode.

What must agree: the restart count and the status exactly; the residual
history within rtol 1e-4 and atol 1e-6 of its scale, and x within rtol
1e-4 and atol 1e-5 (float32 Gram-Schmidt and Givens sums in another
order drift apart by a few ulps per step, and the last residual sits
near the float32 floor of ‖b − A x‖); stack contents and index rules
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solvers import LoopProgram as JLoopProgram
from repro_torch.core import lowering
from repro_torch.core.runtime import inputs_from_numpy
from repro_torch.solvers import LoopProgram, specs

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(n, seed=0):
    m = _rng(seed).standard_normal((n, n))
    return (m @ m.T / n + np.eye(n)).astype(np.float32)


def _nonsym(n, seed=3):
    a = _rng(seed).standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    return a.astype(np.float32)


def _rhs(n, seed=1):
    return _rng(seed).standard_normal(n).astype(np.float32)


def _ops(a, b):
    return {"A": a, "b": b, "x0": np.zeros(b.shape[0], np.float32)}


def _solve_both(raw, mode, ops, **kw):
    """(port LoopProgram, port result, reference result) of one solve."""
    tol = kw.pop("tol", None)
    lp = LoopProgram(raw, mode=mode, device="cpu", **kw)
    got = lp.solve(tol=tol, **inputs_from_numpy(ops, device="cpu"))
    want = JLoopProgram(raw, mode=mode, **kw).solve(
        tol=tol, **{k: jnp.asarray(v) for k, v in ops.items()})
    return lp, got, want


def _assert_same_solve(got, want, x_atol=1e-5):
    assert int(got.iterations) == int(want.iterations)
    assert got.status_names() == want.status_names()
    hist, whist = got.history.numpy(), np.asarray(want.history)
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(whist))
    scale = float(np.nanmax(np.abs(whist)))
    np.testing.assert_allclose(hist, whist, rtol=1e-4, atol=1e-6 * scale)
    x, wx = got.x.numpy(), np.asarray(want.x)
    assert x.shape == wx.shape and x.dtype == np.float32
    np.testing.assert_allclose(x, wx, rtol=1e-4, atol=x_atol)


# ---------------------------------------------------------------------------
# GMRES(m) against the reference, mode for mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_gmres_matches_reference(mode):
    n = 48
    ops = _ops(_nonsym(n), _rhs(n))
    lp, got, want = _solve_both(specs.gmres_loop(m=6), mode, ops,
                                max_iters=40)
    assert got.status_names() == "CONVERGED"
    _assert_same_solve(got, want)
    assert got.iterations.dtype == torch.int32
    assert lp.trace_count == 1


@pytest.mark.parametrize("mode", MODES)
def test_gmres_loop_as_shipped_matches_reference(mode):
    """GMRES_LOOP itself (m = 20) on a system it needs two restarts
    for."""
    n = 64
    a = _rng(5).standard_normal((n, n)) / np.sqrt(n) + 1.5 * np.eye(n)
    ops = _ops(a.astype(np.float32), _rhs(n, seed=6))
    _, got, want = _solve_both(specs.GMRES_LOOP, mode, ops)
    assert got.status_names() == "CONVERGED" and int(got.iterations) >= 2
    _assert_same_solve(got, want)


@pytest.mark.parametrize("make_a", [_spd, _nonsym],
                         ids=["spd", "nonsymmetric"])
def test_gmres_matches_scipy(make_a):
    scipy_linalg = pytest.importorskip("scipy.sparse.linalg")
    n, m = 64, 8
    a, b = make_a(n), _rhs(n)
    lp = LoopProgram(specs.gmres_loop(m=m), max_iters=40, device="cpu")
    got = lp.solve(tol=1e-6, **inputs_from_numpy(_ops(a, b),
                                                 device="cpu"))
    assert bool(got.converged) and lp.trace_count == 1
    x = got.x.numpy().astype(np.float64)
    relres = np.linalg.norm(b - a.astype(np.float64) @ x) / \
        np.linalg.norm(b)
    assert relres <= 1e-5
    xs, info = scipy_linalg.gmres(a, b, rtol=1e-6, restart=m, maxiter=40)
    assert info == 0
    np.testing.assert_allclose(x, xs, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_gmres_identity_happy_breakdown(mode):
    """A = I breaks down after one Arnoldi step (w' = 0): the safe
    divides keep the unfilled slots zero, the zero Givens tail rotates
    nothing, and the filled prefix solves the system in one restart."""
    n = 24
    ops = _ops(np.eye(n, dtype=np.float32), _rhs(n))
    _, got, want = _solve_both(specs.gmres_loop(m=6), mode, ops,
                               max_iters=5, tol=1e-6)
    assert got.status_names() == "CONVERGED" and int(got.iterations) == 1
    np.testing.assert_allclose(got.x.numpy(), ops["b"], rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isfinite(got.x).all())
    _assert_same_solve(got, want)


def test_gmres_exact_in_one_restart_when_m_covers_the_spectrum():
    n = 12
    a, b = _nonsym(n, seed=7), _rhs(n)
    _, got, want = _solve_both(specs.gmres_loop(m=n), "dataflow",
                               _ops(a, b), max_iters=5, tol=1e-5)
    assert int(got.iterations) == 1
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(a, b),
                               rtol=1e-3, atol=1e-4)
    _assert_same_solve(got, want)


def test_gmres_describe_reports_nested_structure():
    desc = LoopProgram(specs.gmres_loop(m=4), device="cpu").describe()
    assert "inner loop (counter j)" in desc
    assert "V[5]" in desc                       # stack + slot count
    assert "store" in desc and "read" in desc
    assert "count 4" in desc
    assert "inner store: Hc[j, j + 1] = hnorm" in desc
    assert LoopProgram(specs.gmres_loop(m=4), device="cpu",
                       mode="reference").describe().count(
                           "inner loop") == 3


def test_gmres_loop_lowers_once_through_the_cache():
    spec = specs.gmres_loop(m=5)
    LoopProgram(spec, device="cpu")
    before = lowering.cache_stats()
    LoopProgram(spec, device="cpu")
    after = lowering.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]


def test_two_solves_are_bitwise_equal_and_do_not_share_stacks():
    n = 48
    ops = inputs_from_numpy(_ops(_nonsym(n), _rhs(n)), device="cpu")
    lp = LoopProgram(specs.gmres_loop(m=6), device="cpu")
    a = ops["A"].clone()
    first, second = lp.solve(**ops), lp.solve(**ops)
    assert torch.equal(first.x, second.x)
    assert torch.equal(ops["A"], a)             # operands never written
    assert lp.trace_count == 1


# ---------------------------------------------------------------------------
# The inner metric stop rule, index rules and value semantics
# ---------------------------------------------------------------------------


def _base(body, state=None, solution=None, max_iters=1, feedback=None):
    """A one-iteration loop around `body` on (A, b, x0), ending with the
    residual of x: tests/test_gmres.py's frame."""
    return {
        "name": "frame",
        "operands": {"A": "matrix", "b": "vector", "x0": "vector"},
        "setup": [
            {"program": specs.NRM2, "inputs": {"x": "b"},
             "outputs": {"norm": "bnorm"}},
            {"program": specs.RESIDUAL, "inputs": {"x": "x0"},
             "outputs": {"r": "r0", "rnorm": "rnorm0"}},
        ],
        "iterate": {
            "state": {"x": {"init": "x0"}, "r": {"init": "r0"},
                      **(state or {})},
            "body": body + [
                {"program": specs.RESIDUAL, "inputs": {"x": "x_out"},
                 "outputs": {"r": "r_next", "rnorm": "rnorm"}}],
            "feedback": {"x": "x_out", "r": "r_next", **(feedback or {})},
            "while": {"metric": "rnorm", "init": "rnorm0",
                      "scale": "bnorm", "rtol": 1e-6,
                      "max_iters": max_iters},
            "solution": {"x": "x", **(solution or {})},
        },
    }


def _frame_ops(n=16, seed=4):
    a = (_rng(seed).standard_normal((n, n)) / np.sqrt(n)
         + 2.0 * np.eye(n)).astype(np.float32)
    return _ops(a, _rhs(n, seed=seed + 1))


def _aux_equal(got, want, names):
    for name in names:
        np.testing.assert_array_equal(got.aux[name].numpy(),
                                      np.asarray(want.aux[name]))


def test_inner_loop_metric_stop_rule():
    """An inner iterate may stop on its own metric <= rtol * scale
    (with a static max_iters bound): h halves from ‖b‖ until it is at
    most 0.1 ‖b‖, four halvings, each one metric read."""
    body = [
        {"iterate": {
            "counter": "k",
            "state": {"h": {"init": "rnorm0"}},
            "body": [{"let": {"h2": "h * 0.5"}}],
            "feedback": {"h": "h2"},
            "while": {"metric": "h2", "init": "rnorm0",
                      "scale": "bnorm", "rtol": 0.1, "max_iters": 64},
            "yield": {"hfin": "h"},
        }},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "hfin",
                                                 "x": "b"},
         "outputs": {"out": "x_out"}},
    ]
    n = 16
    ops = _ops(np.eye(n, dtype=np.float32), np.ones(n, np.float32))
    for mode in MODES:
        _, got, want = _solve_both(_base(body), mode, ops)
        # x = hfin * b with hfin = 0.5**4 * ‖b‖
        np.testing.assert_allclose(got.x.numpy(),
                                   0.0625 * np.sqrt(n) * np.ones(n),
                                   rtol=1e-6)
        _assert_same_solve(got, want)


# slot expressions: host ints (counters and literals) and device
# indices (anything naming a tensor, here z = 0 * rnorm0)
INDEX_CASES = {
    "host in range": ("k", "2"),
    "host negative counts from the end": ("k - 4", "0 - 1"),
    "host past the end drops and clamps": ("k + 1", "9"),
    "host below the start drops and clamps": ("k - 9", "0 - 7"),
    "device in range": ("k + z", "2 + z"),
    "device negative": ("k - 4 + z", "z - 1"),
    "device past the end": ("k + 1 + z", "9 + z"),
    "device below the start": ("k - 9 + z", "z - 7"),
    "truncated toward zero": ("k * 0.75", "2.9 + z"),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_stack_index_rules_match_reference(case):
    """A store of k + 1 at each of 6 inner iterations into a 4-slot
    scalar stack and a vector stack's elements, then one read: negative
    indices count from the end, a store out of range is dropped and a
    read clamps into range, in the host and the device index paths
    alike."""
    store, read = INDEX_CASES[case]
    body = [
        {"let": {"z": "0 * rnorm0"}},
        {"iterate": {
            "counter": "k",
            "state": {"T": {"kind": "stack", "slots": 4, "of": "scalar"},
                      "E": {"kind": "stack", "slots": 2, "of": "vector",
                            "len": 4}},
            "body": [{"let": {"v": "k + 1"}},
                     {"store": {"into": "T", "slot": store, "value": "v"}},
                     {"store": {"into": "E", "slot": "1", "at": store,
                                "value": "v"}}],
            "while": {"count": 6},
            "yield": {"Tf": "T", "Ef": "E"},
        }},
        {"read": {"name": "t", "from": "Tf", "slot": read}},
        {"read": {"name": "e1", "from": "Ef", "slot": "1"}},
        {"store": {"into": "S", "slot": "0", "value": "t"}},
        {"store": {"into": "W", "slot": "0", "value": "e1"}},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "t", "x": "b"},
         "outputs": {"out": "x_out"}},
    ]
    raw = _base(body, state={
        "S": {"kind": "stack", "slots": 1, "of": "scalar"},
        "W": {"kind": "stack", "slots": 1, "of": "vector", "len": 4}},
        solution={"S": "S", "W": "W"})
    ops = _frame_ops()
    for mode in ("dataflow", "reference"):
        # verify=False: the reference's static analyzer refuses a slot
        # it proves out of range before the rule under test could run
        _, got, want = _solve_both(raw, mode, ops, verify=False)
        _aux_equal(got, want, ("S", "W"))
        _assert_same_solve(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_read_keeps_its_value_after_its_slot_is_stored_again(mode):
    """v = S[0] is read, S[0] is stored again, then v is used: v keeps
    the value it was read with (x = x0 + r0, not x0 + 2 r0)."""
    body = [
        {"store": {"into": "S", "slot": "0", "value": "r"}},
        {"read": {"name": "v", "from": "S", "slot": "0"}},
        {"let": {"two": "2"}},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "two",
                                                 "x": "r"},
         "outputs": {"out": "r2"}},
        {"store": {"into": "S", "slot": "0", "value": "r2"}},
        {"let": {"one": "1"}},
        {"program": specs.GMRES_AXPY,
         "inputs": {"yq": "one", "v": "v", "x": "x"},
         "outputs": {"xn": "x_out"}},
    ]
    raw = _base(body, state={"S": {"kind": "stack", "slots": 2,
                                   "of": "vector", "like": "b"}},
                solution={"S": "S"})
    ops = _frame_ops()
    _, got, want = _solve_both(raw, mode, ops)
    _assert_same_solve(got, want)
    a, b = ops["A"].astype(np.float64), ops["b"].astype(np.float64)
    np.testing.assert_allclose(got.x.numpy(), b - a @ ops["x0"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.aux["S"].numpy()[0],
                               2.0 * got.x.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_stack_from_a_buffer_is_a_copy_of_it(mode):
    """An inner stack R adopts A with init.from and stores b into its
    row 0; A's row 0, read after the loop, is still A's (x = A[0] + the
    last row R kept)."""
    body = [
        {"iterate": {
            "counter": "k",
            "state": {"R": {"kind": "stack", "slots": 16, "of": "vector",
                            "init": {"from": "A"}}},
            "body": [{"store": {"into": "R", "slot": "0",
                                "value": "b"}}],
            "while": {"count": 1},
            "yield": {"Rf": "R"},
        }},
        {"read": {"name": "a0", "from": "A", "slot": "0"}},
        {"read": {"name": "rf0", "from": "Rf", "slot": "0"}},
        {"let": {"one": "1"}},
        {"program": specs.GMRES_AXPY,
         "inputs": {"yq": "one", "v": "a0", "x": "rf0"},
         "outputs": {"xn": "x_out"}},
    ]
    ops = _frame_ops()
    a = torch.from_numpy(ops["A"]).clone()
    lp, got, want = _solve_both(_base(body), mode, ops)
    _assert_same_solve(got, want)
    np.testing.assert_allclose(got.x.numpy(), ops["A"][0] + ops["b"],
                               rtol=1e-6)
    assert torch.equal(torch.from_numpy(ops["A"]), a)


@pytest.mark.parametrize("mode", MODES)
def test_bare_alias_and_feedback_of_a_stack_are_copies(mode):
    """A bare-name let of a live stack (P = S), a nested loop's state
    initialised from one (u from S) and a state field fed back from one
    (q from S2) each keep the values they were bound with: p0 = r, not
    2 r; the second inner iteration reads q[0] = b, not 2 b; u[1] stays
    0 after S[1] = b. So x = r + b = 2 b."""
    body = [
        {"store": {"into": "S", "slot": "0", "value": "r"}},
        {"let": {"P": "S", "two": "2", "one": "1"}},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "two",
                                                 "x": "r"},
         "outputs": {"out": "r2"}},
        {"store": {"into": "S", "slot": "0", "value": "r2"}},
        {"read": {"name": "p0", "from": "P", "slot": "0"}},
        {"iterate": {
            "counter": "k",
            "state": {"S2": {"kind": "stack", "slots": 2, "of": "vector",
                             "like": "b"},
                      "q": {"init": "S"}, "acc": {"init": "b"}},
            "body": [
                {"let": {"c": "k + 1"}},
                {"program": specs.GMRES_SCAL,
                 "inputs": {"alpha": "c", "x": "b"},
                 "outputs": {"out": "bk"}},
                {"store": {"into": "S2", "slot": "0", "value": "bk"}},
                {"read": {"name": "q0", "from": "q", "slot": "0"}},
            ],
            "feedback": {"q": "S2", "acc": "q0"},
            "while": {"count": 2},
            "yield": {"accf": "acc"},
        }},
        # u adopts S by name and is yielded past a store into S[1]
        {"iterate": {
            "state": {"u": {"init": "S"}},
            "body": [{"let": {"u2": "u"}}],
            "feedback": {"u": "u2"},
            "while": {"count": 1},
            "yield": {"uf": "u"},
        }},
        {"store": {"into": "S", "slot": "1", "value": "b"}},
        {"read": {"name": "u1", "from": "uf", "slot": "1"}},
        {"program": specs.GMRES_AXPY,
         "inputs": {"yq": "one", "v": "p0", "x": "accf"},
         "outputs": {"xn": "xa"}},
        {"program": specs.GMRES_AXPY,
         "inputs": {"yq": "one", "v": "u1", "x": "xa"},
         "outputs": {"xn": "x_out"}},
    ]
    raw = _base(body, state={"S": {"kind": "stack", "slots": 2,
                                   "of": "vector", "like": "b"}})
    ops = _frame_ops()
    _, got, want = _solve_both(raw, mode, ops)
    _assert_same_solve(got, want)
    np.testing.assert_allclose(got.x.numpy(), 2.0 * ops["b"], rtol=1e-6)


COPY_SPEC = {"name": "cp", "routines": [
    {"blas": "copy", "name": "cp", "inputs": {"x": "x"},
     "outputs": {"out": "y"}}]}


@pytest.mark.parametrize("mode", MODES)
def test_program_outputs_are_not_views_of_a_stack(mode):
    """A program's output keeps its value when the stack it was made
    from is stored again: a copy of T and the transpose of S, both
    taken before T[0] and S[0] are overwritten, so
    x = 1 b + r[0] b, not 2 b + 2 r[0] b."""
    body = [
        {"let": {"one": "1", "two": "2"}},
        {"store": {"into": "T", "slot": "0", "value": "one"}},
        {"program": COPY_SPEC, "inputs": {"x": "T"},
         "outputs": {"y": "Tc"}},
        {"store": {"into": "T", "slot": "0", "value": "two"}},
        {"store": {"into": "S", "slot": "0", "value": "r"}},
        {"program": specs.GMRES_TRANSPOSE, "inputs": {"Hb": "S"},
         "outputs": {"Hm": "St"}},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "two",
                                                 "x": "r"},
         "outputs": {"out": "r2"}},
        {"store": {"into": "S", "slot": "0", "value": "r2"}},
        {"read": {"name": "c0", "from": "Tc", "slot": "0"}},
        {"read": {"name": "st0", "from": "St", "slot": "0"}},
        {"read": {"name": "e", "from": "st0", "slot": "0"}},
        {"program": specs.GMRES_SCAL, "inputs": {"alpha": "c0",
                                                 "x": "b"},
         "outputs": {"out": "xs"}},
        {"program": specs.GMRES_AXPY,
         "inputs": {"yq": "e", "v": "b", "x": "xs"},
         "outputs": {"xn": "x_out"}},
    ]
    raw = _base(body, state={
        "T": {"kind": "stack", "slots": 3, "of": "scalar"},
        "S": {"kind": "stack", "slots": 2, "of": "vector", "like": "b"}})
    ops = _frame_ops()
    _, got, want = _solve_both(raw, mode, ops)
    _assert_same_solve(got, want)
    b = ops["b"]
    np.testing.assert_allclose(got.x.numpy(), (1.0 + b[0]) * b, rtol=1e-6)
