"""Port parity for slice 3's loop path: the loop lowering
(`core/lowering.py::lower_loop`) and `repro_torch.solvers.LoopProgram`
against the reference's `repro.solvers.LoopProgram`, on the CPU. The
same seeded numpy operands go through both; the port's stage programs
run their plain versions.

What must agree: the iteration count and the status exactly; the
residual history and x within rtol 1e-4 and atol 1e-6 of their scale
(float32 recurrences summed in another order drift apart by a few ulps
per iteration, and a few tens of iterations stay well inside 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lowering as jlowering
from repro.core.spec import SpecError as JSpecError
from repro.solvers import LoopProgram as JLoopProgram, specs as jspecs
from repro_torch import guard
from repro_torch.core import lowering
from repro_torch.core.runtime import inputs_from_numpy
from repro_torch.core.spec import SpecError
from repro_torch.solvers import LoopProgram, SolverResult, specs

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(n, seed):
    m = _rng(seed).standard_normal((n, n))
    return (m @ m.T / n + np.eye(n)).astype(np.float32)


def _operands(name, seed=1):
    """Seeded operands of each loop spec, small enough for the CPU."""
    rng = _rng(seed)
    if name == "CG_LOOP":
        n = 64
        return {"A": _spd(n, seed), "b": rng.standard_normal(n).astype(
            np.float32), "x0": np.zeros(n, np.float32)}
    if name == "JACOBI_LOOP":
        n = 96
        a = _spd(n, seed)
        a = a + 2.0 * np.diag(np.abs(a).sum(axis=1)).astype(np.float32)
        return {"A": a, "b": rng.standard_normal(n).astype(np.float32),
                "x0": np.zeros(n, np.float32),
                "dinv": (1.0 / np.diag(a)).astype(np.float32),
                "omega": np.float32(1.0)}
    if name == "BICGSTAB_LOOP":
        n = 64
        a = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
        return {"A": a.astype(np.float32),
                "b": rng.standard_normal(n).astype(np.float32),
                "x0": np.zeros(n, np.float32)}
    assert name == "BLOCK_CG_LOOP"
    n, s = 48, 3
    return {"A": _spd(n, seed), "B": rng.standard_normal((n, s)).astype(
        np.float32), "x0": np.zeros((n, s), np.float32)}


_REFERENCE: dict = {}


def _reference(name, mode, ops, **kw):
    """The reference's result, solved once per case for the module."""
    key = (name, mode, tuple(sorted(kw.items())),
           tuple((k, np.asarray(v).tobytes()) for k, v in sorted(
               ops.items())))
    if key not in _REFERENCE:
        tol = kw.pop("tol", None)
        res = JLoopProgram(getattr(jspecs, name), mode=mode, **kw).solve(
            tol=tol, **{k: jnp.asarray(v) for k, v in ops.items()})
        _REFERENCE[key] = res
    return _REFERENCE[key]


def _port(name, mode, ops, **kw):
    tol = kw.pop("tol", None)
    lp = LoopProgram(getattr(specs, name), mode=mode, device="cpu", **kw)
    return lp, lp.solve(tol=tol, **inputs_from_numpy(ops, device="cpu"))


def _assert_same_solve(got, want):
    assert int(got.iterations) == int(want.iterations)
    assert got.status_names() == want.status_names()
    assert bool(got.converged) == bool(want.converged)
    hist, whist = got.history.numpy(), np.asarray(want.history)
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(whist))
    scale = float(np.nanmax(np.abs(whist))) if np.isfinite(whist).any() \
        else 1.0
    np.testing.assert_allclose(hist, whist, rtol=1e-4, atol=1e-6 * scale)
    x, wx = got.x.numpy(), np.asarray(want.x)
    assert x.shape == wx.shape and x.dtype == np.float32
    np.testing.assert_allclose(
        x, wx, rtol=1e-4, atol=1e-6 * max(1.0, float(np.nanmax(np.abs(wx)))))


LOOPS = ["CG_LOOP", "JACOBI_LOOP", "BICGSTAB_LOOP", "BLOCK_CG_LOOP"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", LOOPS)
def test_loop_matches_reference(name, mode):
    ops = _operands(name)
    lp, got = _port(name, mode, ops)
    want = _reference(name, mode, ops)
    assert got.status_names() == "CONVERGED"
    _assert_same_solve(got, want)
    assert got.iterations.dtype == torch.int32
    assert got.status.dtype == torch.int8
    assert lp.trace_count == 1


@pytest.mark.parametrize("case", ["max_iters", "breakdown", "nonfinite"])
def test_statuses_match_reference(case):
    """MAX_ITERS from a small budget; BREAKDOWN from a zero column of B
    (that column's p'Ap is 0); NONFINITE from a NaN in B (the first
    metric is NaN, so the solve stops before its first iteration)."""
    name, kw = "BLOCK_CG_LOOP", {}
    ops = _operands(name, seed=7)
    if case == "max_iters":
        kw = {"max_iters": 3}
    elif case == "breakdown":
        ops["B"][:, 1] = 0.0
    else:
        ops["B"][5, 2] = np.nan
    _, got = _port(name, "dataflow", ops, **kw)
    want = _reference(name, "dataflow", ops, **kw)
    assert got.status_names() == want.status_names() == {
        "max_iters": "MAX_ITERS", "breakdown": "BREAKDOWN",
        "nonfinite": "NONFINITE"}[case]
    assert int(got.iterations) == int(want.iterations)
    hist, whist = got.history.numpy(), np.asarray(want.history)
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(whist))
    np.testing.assert_allclose(hist, whist, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.isnan(got.x.numpy()),
                                  np.isnan(np.asarray(want.x)))


def test_cg_max_iters_and_tol_override():
    ops = _operands("CG_LOOP", seed=3)
    _, got = _port("CG_LOOP", "nodataflow", ops, max_iters=4, tol=0.0)
    want = _reference("CG_LOOP", "nodataflow", ops, max_iters=4, tol=0.0)
    assert int(got.iterations) == 4 and got.status_names() == "MAX_ITERS"
    _assert_same_solve(got, want)
    assert len(got.history_trimmed()) == 5
    assert "MAX_ITERS" in repr(got)


def test_body_builds_once_and_stage_programs_hit_the_cache():
    ops = inputs_from_numpy(_operands("BLOCK_CG_LOOP"), device="cpu")
    lp = LoopProgram(specs.BLOCK_CG_LOOP, max_iters=4, device="cpu")
    misses = lowering.cache_stats()["misses"]
    assert misses == 5        # the five distinct block-CG programs
    first = lp.solve(tol=0.0, **ops)
    second = lp.solve(tol=0.0, **ops)
    assert lp.trace_count == 1
    assert int(first.iterations) == int(second.iterations) == 4
    assert torch.equal(first.x, second.x)
    before = lowering.cache_stats()
    again = LoopProgram(specs.BLOCK_CG_LOOP, max_iters=4, device="cpu")
    after = lowering.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] == before["hits"] + 5
    again.solve(tol=0.0, **ops)
    assert again.trace_count == 1


def test_operand_mismatch_raises():
    lp = LoopProgram(specs.CG_LOOP, device="cpu")
    with pytest.raises(ValueError, match="operand mismatch"):
        lp.solve(A=torch.eye(8), b=torch.ones(8))          # missing x0
    with pytest.raises(ValueError, match="operand mismatch"):
        lp.solve(A=torch.eye(8), b=torch.ones(8), x0=torch.zeros(8),
                 extra=torch.ones(8))
    with pytest.raises(TypeError, match="must be a tensor"):
        lp.solve(A=np.eye(8), b=torch.ones(8), x0=torch.zeros(8))


def test_loop_ir_pins_mode():
    """A pre-lowered LoopIR carries its compilation mode; LoopProgram
    adopts it and rejects a conflicting override."""
    lir = lowering.lower_loop(specs.CG_LOOP, mode="nodataflow",
                              device="cpu")
    lp = LoopProgram(lir)
    assert lp.mode == "nodataflow" and lp.device == torch.device("cpu")
    assert "FUSED" not in lp.describe()
    with pytest.raises(ValueError, match="lowered for mode"):
        LoopProgram(lir, mode="dataflow")
    assert "FUSED mv-anchored streaming group]: mv -> pq" in LoopProgram(
        specs.BLOCK_CG_LOOP, device="cpu").describe()
    assert "cond: if snorm <= threshold" in LoopProgram(
        specs.BICGSTAB_LOOP, device="cpu").describe()


@pytest.mark.parametrize("kw,match", [
    ({"b": torch.ones(2, 8), "x0": torch.zeros(2, 8),
      "axes": {"nope": 0}}, "axes for unknown operands"),
    ({"b": torch.ones(2, 8), "x0": torch.zeros(3, 8)},
     "disagree on the batch size"),
    ({"b": torch.ones(8), "x0": torch.zeros(8),
      "axes": {"b": None, "x0": None}}, "at least one input"),
    ({"b": torch.ones(2, 8)}, "operand mismatch"),
])
def test_batched_checks_its_operands(kw, match):
    """The reference's operand check (tests/test_loop_program.py:247),
    and the lane counts that a vmap would refuse."""
    lp = LoopProgram(specs.CG_LOOP, device="cpu")
    with pytest.raises(ValueError, match=match):
        lp.batched(A=torch.eye(8), **kw)


def _lane(res, i):
    """Lane `i` of a batched result of either package, as a result of
    one solve."""
    return type(res)(x=res.x[i], iterations=res.iterations[i],
                     residual=res.residual[i], history=res.history[i],
                     converged=res.converged[i], status=res.status[i])


def _batched_pair(name, ops, axes=None, lanes=(), **kw):
    """The port's and the reference's batched solves of one spec on the
    same operands (`lanes` names the operands whose default axis the
    test keeps)."""
    tol = kw.pop("tol", None)
    lp = LoopProgram(getattr(specs, name), device="cpu", **kw)
    got = lp.batched(tol=tol, axes=axes,
                     **inputs_from_numpy(ops, device="cpu"))
    want = JLoopProgram(getattr(jspecs, name), **kw).batched(
        tol=tol, axes=axes, **{k: jnp.asarray(v) for k, v in ops.items()})
    return lp, got, want


def test_batched_matches_reference_and_per_rhs_solves():
    """tests/test_loop_program.py:144: every lane is the reference's
    vmapped lane, and bitwise the port's own solve of that column."""
    n, nrhs = 72, 3
    A = _spd(n, 0)
    B = np.stack([_rng(s).standard_normal(n).astype(np.float32)
                  for s in range(1, nrhs + 1)])
    ops = {"A": A, "b": B, "x0": np.zeros_like(B)}
    lp, got, want = _batched_pair("CG_LOOP", ops, axes={"A": None},
                                  max_iters=100, tol=1e-6)
    assert got.x.shape == (nrhs, n)
    assert got.history.shape == tuple(want.history.shape) == \
        (nrhs, lp.max_iters + 1)
    assert got.iterations.dtype == torch.int32
    assert got.status.dtype == torch.int8
    assert got.attempts is None and lp.trace_count == 1
    for i in range(nrhs):
        _assert_same_solve(_lane(got, i), _lane(want, i))
        single = lp.solve(A=torch.from_numpy(A), b=torch.from_numpy(B[i]),
                          x0=torch.zeros(n), tol=1e-6)
        assert int(got.iterations[i]) == int(single.iterations)
        assert bool(got.converged[i])
        assert torch.equal(got.x[i], single.x)
        assert torch.equal(got.history[i].nan_to_num(-1.0),
                           single.history.nan_to_num(-1.0))
    assert lp.trace_count == 1
    assert repr(got) == (f"SolverResult(batch={nrhs}, iterations="
                         f"{got.iterations.tolist()}, status="
                         f"{['CONVERGED'] * nrhs})")


def test_batched_default_axes_batch_vectors():
    """tests/test_loop_program.py:165: without `axes` every vector
    operand batches and matrix and scalar operands broadcast."""
    n, nrhs = 48, 2
    ops = _operands("JACOBI_LOOP")
    ops["A"] = ops["A"][:n, :n]
    B = np.stack([_rng(s).standard_normal(n).astype(np.float32)
                  for s in (5, 6)])
    ops.update(b=B, x0=np.zeros_like(B),
               dinv=np.broadcast_to(1.0 / np.diag(ops["A"]), (nrhs, n))
               .astype(np.float32))
    _, got, want = _batched_pair("JACOBI_LOOP", ops, max_iters=300,
                                 tol=1e-6)
    for i in range(nrhs):
        _assert_same_solve(_lane(got, i), _lane(want, i))
        np.testing.assert_allclose(
            got.x[i].numpy(), np.linalg.solve(ops["A"], B[i]),
            rtol=1e-4, atol=1e-5)


def test_batched_axes_pick_the_reference_lanes():
    """A non-zero axis selects the lane that the reference's `in_axes`
    does: B and x0 given as (n, nrhs) columns, a batched scalar."""
    n, nrhs = 48, 3
    ops = _operands("JACOBI_LOOP")
    ops["A"] = ops["A"][:n, :n]
    ops.update(b=_rng(9).standard_normal((n, nrhs)).astype(np.float32),
               x0=np.zeros((n, nrhs), np.float32),
               dinv=(1.0 / np.diag(ops["A"])).astype(np.float32),
               omega=np.array([1.0, 0.9, 0.8], np.float32))
    axes = {"b": 1, "x0": 1, "dinv": None, "omega": 0}
    _, got, want = _batched_pair("JACOBI_LOOP", ops, axes=axes,
                                 max_iters=300, tol=1e-6)
    assert got.x.shape == (nrhs, n)
    for i in range(nrhs):
        _assert_same_solve(_lane(got, i), _lane(want, i))
    assert len({int(k) for k in got.iterations}) > 1


def test_loop_program_resolves_tiles_auto():
    """`tiles="auto"` (a refusal naming ROADMAP Queue 1, item 12 until
    the tuner was ported) is the default: on a cold table every stage
    program resolves to the empty plan and shares the `"default"`
    compile."""
    auto = LoopProgram(specs.CG_LOOP, device="cpu", tiles="auto")
    default = LoopProgram(specs.CG_LOOP, device="cpu", tiles="default")
    for a, d in zip(auto.lir.body, default.lir.body):
        if a.tag == "program":
            assert a.ir is d.ir and not a.ir.tile_plan


def test_lower_loop_threads_a_fault_plan_to_matching_stages():
    """`lower_loop(fault=)` (a refusal until the guard layer was ported)
    wraps exactly the stage programs the plan matches, compiled apart
    from the cache, and the faulted solve stops where the reference's
    does: same status and iteration count."""
    from repro.guard import chaos as jchaos
    from repro_torch.guard import chaos

    plan = chaos.FaultPlan(program="cg_matvec", kind="nan", iteration=2)
    lir = lowering.lower_loop(specs.CG_LOOP, device="cpu", fault=plan)
    for cs in lir.setup + lir.body:
        if cs.tag != "program":
            continue
        faulted = cs.ir.spec.name == "cg_matvec"
        assert (cs.ir.fn.__name__ == "faulted") == faulted
        assert (cs.ir in lowering._CACHE.values()) != faulted
    ops = _operands("CG_LOOP")
    res = LoopProgram(lir).solve(**inputs_from_numpy(ops, device="cpu"))
    jres = JLoopProgram(jspecs.CG_LOOP, fault=jchaos.FaultPlan(
        program="cg_matvec", kind="nan", iteration=2)).solve(
            **{k: jnp.asarray(v) for k, v in ops.items()})
    assert res.status_names() == jres.status_names() == "NONFINITE"
    assert int(res.iterations) == int(jres.iterations) == 3
    with pytest.raises(ValueError, match="threaded through lowering"):
        LoopProgram(lir, fault=plan)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoopProgram(specs.CG_LOOP)


def test_status_codes_equal_the_reference():
    from repro.guard import status as jstatus
    assert guard.STATUS_NAMES == jstatus.STATUS_NAMES
    for code in jstatus.STATUS_NAMES:
        assert guard.status_name(code) == jstatus.status_name(code)
        assert guard.is_failure(code) == jstatus.is_failure(code)
    assert guard.status_name(torch.tensor(3, dtype=torch.int8)) == \
        "NONFINITE"
    assert SolverResult.__dataclass_fields__.keys() >= {
        "x", "iterations", "residual", "history", "converged", "status"}


def test_solver_specs_equal_the_reference():
    names = [n for n in dir(jspecs) if n.isupper()]
    assert len(names) >= 30
    for name in names:
        assert getattr(specs, name) == getattr(jspecs, name), name
    assert sorted(n for n in dir(specs) if n.isupper()) == sorted(names)
    for m in (5, 20, 30):
        assert specs.gmres_loop(m, rtol=1e-8) == jspecs.gmres_loop(
            m, rtol=1e-8)


# ---------------------------------------------------------------------------
# Spec errors: the reference's codes, paths and messages
# ---------------------------------------------------------------------------


def _loop():
    """A minimal valid loop spec (Richardson on A) to mutate: the base of
    tests/test_spec_errors.py."""
    return {
        "name": "mini",
        "operands": {"A": "matrix", "b": "vector", "x0": "vector"},
        "setup": [
            {"program": specs.NRM2, "inputs": {"x": "b"},
             "outputs": {"norm": "bnorm"}},
            {"program": specs.RESIDUAL, "inputs": {"x": "x0"},
             "outputs": {"r": "r0", "rnorm": "rnorm0"}},
        ],
        "iterate": {
            "state": {"x": {"init": "x0"}, "r": {"init": "r0"}},
            "body": [
                {"program": specs.RESIDUAL, "inputs": {"x": "x"},
                 "outputs": {"r": "r_next", "rnorm": "rnorm"}},
            ],
            "feedback": {"x": "x", "r": "r_next"},
            "while": {"metric": "rnorm", "init": "rnorm0",
                      "scale": "bnorm", "max_iters": 5},
            "solution": {"x": "x"},
        },
    }


def _it(**over):
    bad = _loop()
    bad["iterate"] = {**bad["iterate"], **over}
    return bad


def _block_it(**over):
    return {**specs.BLOCK_CG_LOOP,
            "iterate": {**specs.BLOCK_CG_LOOP["iterate"], **over}}


def _state(**extra):
    return {"x": {"init": "x0"}, "r": {"init": "r0"}, **extra}


_RES = {"program": specs.RESIDUAL, "inputs": {"x": "x"},
        "outputs": {"r": "r_next", "rnorm": "rnorm"}}

BROKEN = {
    "feedback_missing": _it(feedback={"r": "nosuch", "x": "x"}),
    "feedback_scalar_into_vector": _it(feedback={"r": "rnorm", "x": "x"}),
    "scalar_into_window": _it(
        state=_state(t={"init": "rnorm0 * 2"}),
        body=[{**_RES, "inputs": {"x": "t"}}]),
    "cyclic": _it(body=[
        {"program": specs.NRM2, "inputs": {"x": "r_next2"},
         "outputs": {"norm": "rnorm"}},
        {**_RES, "outputs": {"r": "r_next2", "rnorm": "rn2"}}],
        feedback={"r": "r_next2", "x": "x"}),
    "rebind": _it(body=[_RES, {**_RES, "outputs": {"r": "r_next",
                                                   "rnorm": "rn2"}}]),
    "let_over_vector": _it(body=[{"let": {"bad": "r * 2"}}, _RES]),
    "metric_not_produced": _it(**{"while": {
        "metric": "bnorm", "init": "rnorm0", "max_iters": 5}}),
    "metric_not_scalar": _it(**{"while": {
        "metric": "r_next", "init": "rnorm0", "max_iters": 5}}),
    "init_not_scalar": _it(**{"while": {
        "metric": "rnorm", "init": "r0", "max_iters": 5}}),
    "threshold_reserved": _it(state=_state(threshold={"init": "bnorm"})),
    "declared_kind": _it(state=_state(s={"init": "r0", "kind": "scalar"})),
    "cond_nothing_common": _it(body=[_RES, {"cond": {
        "if": "rnorm <= threshold", "then": [{"let": {"a": "rnorm"}}],
        "else": [{"let": {"b": "rnorm"}}]}}]),
    "cond_kind_mismatch": _it(body=[_RES, {"cond": {
        "if": "rnorm <= threshold", "then": [{"let": {"a": "rnorm"}}],
        "else": [{"let": {"a": "r_next"}}]}}]),
    "unknown_program_input": _it(body=[{**_RES, "inputs": {
        "x": "x", "nope": "r"}}]),
    "unknown_program_output": _it(body=[{**_RES, "outputs": {
        "r": "r_next", "rnorm": "rnorm", "zz": "q"}}]),
    "guard_not_produced": _it(guards={"breakdown": [
        {"value": "bnorm", "below": 1e-30}]}),
    "guard_unknown_name": _it(guards={"nonfinite": ["nosuch"]}),
    "guard_not_scalar": _block_it(guards={"breakdown": [
        {"value": "q", "below": 1e-30}]}),
    "matrix_feedback": _block_it(feedback={
        **specs.BLOCK_CG_LOOP["iterate"]["feedback"], "x": "rz_next"}),
}


def _body(*stages, **state):
    """A loop whose body is the given stages followed by the metric
    producer, with extra state fields: tests/test_spec_errors.py's
    grammar-v2 frame."""
    return _it(state=_state(**state), body=list(stages) + [_RES])


def _inner(**over):
    """A valid nested iterate (h halves twice), with fields replaced."""
    return {"iterate": {"state": {"h": {"init": "rnorm0"}},
                        "body": [{"let": {"h2": "h * 0.5"}}],
                        "feedback": {"h": "h2"},
                        "while": {"count": 2}, **over}}


def _stack(**field):
    return {"kind": "stack", **field}


_S3 = _stack(slots=3, of="scalar")
_V3 = _stack(slots=3, of="vector", like="r0")

# stack state, read/store stages and nested loops (the reference's
# tests/test_spec_errors.py grammar-v2 cases, and the rest of its
# lowering checks)
BROKEN.update({
    "store_outside_stack": _body(
        {"store": {"into": "r", "slot": "0", "value": "r"}}),
    "store_inside_cond": _body(
        {"let": {"one": "1"}},
        {"cond": {"if": "rnorm0 <= 1", "then": [
            {"store": {"into": "S", "slot": "0", "value": "one"}}],
            "else": [{"let": {"zz": "1"}}]}}, S=_S3),
    "read_from_scalar": _body(
        {"read": {"name": "z", "from": "rnorm0", "slot": "0"}}),
    "read_from_unknown": _body(
        {"read": {"name": "z", "from": "nosuch", "slot": "0"}}),
    "read_slot_not_scalar": _body(
        {"read": {"name": "z", "from": "r0", "slot": "r0"}}),
    "read_rebinds": _body(
        {"read": {"name": "r0", "from": "r", "slot": "0"}}),
    "stack_slots_missing": _body(S=_stack(of="scalar")),
    "stack_of_missing": _body(S=_stack(slots=4)),
    "stack_element_length": _body(S=_stack(slots=4, of="vector")),
    "stack_init_both": _body(S=_stack(slots=4, of="scalar", init={
        "slot0": "a", "from": "b"})),
    "stack_slot0_kind": _body(S=_stack(slots=4, of="scalar",
                                       init={"slot0": "r0"})),
    "stack_slot0_matrix": _body(S=_stack(slots=4, of="matrix",
                                         init={"slot0": "r0"})),
    "stack_like_scalar": _body(S=_stack(slots=4, of="vector",
                                        like="rnorm0")),
    "stack_like_matrix": _body(S=_stack(slots=4, of="matrix", like="r0")),
    "stack_from_vector": _body(S=_stack(slots=4, of="vector",
                                        init={"from": "r0"})),
    "stack_from_matrix": _body(S=_stack(slots=4, of="matrix",
                                        init={"from": "A"})),
    "stack_from_unknown": _body(S=_stack(slots=4, of="scalar",
                                         init={"from": "nosuch"})),
    "stack_feedback_edge": _it(state=_state(S=_S3), feedback={
        "r": "r_next", "x": "x", "S": "r_next"}),
    "store_element_value": _body(
        {"store": {"into": "S", "slot": "0", "value": "r"}}, S=_S3),
    "store_vector_slot_scalar": _body(
        {"store": {"into": "S", "slot": "0", "value": "rnorm0"}}, S=_V3),
    "store_at_scalar_stack": _body(
        {"store": {"into": "S", "slot": "0", "at": "1",
                   "value": "rnorm0"}}, S=_S3),
    "store_at_vector_value": _body(
        {"store": {"into": "S", "slot": "0", "at": "1", "value": "r"}},
        S=_V3),
    "store_slot_not_scalar": _body(
        {"store": {"into": "S", "slot": "r0", "value": "rnorm0"}}, S=_S3),
    "store_value_unknown": _body(
        {"store": {"into": "S", "slot": "0", "value": "nosuch"}}, S=_S3),
    "inner_unknown_keys": _body(_inner(solution={"x": "h"})),
    "inner_metric_needs_max_iters": _body(_inner(**{"while": {
        "metric": "h2"}})),
    "inner_counter_rebind": _body(_inner(counter="rnorm0")),
    "inner_state_shadowing": _body(_inner(
        state={"r0": {"init": "rnorm0"}}, body=[{"let": {"h2": "r0"}}],
        feedback={"r0": "h2"})),
    "inner_yield_unknown_field": _body(_inner(yield_={"out": "nosuch"})),
    "inner_count_extra_keys": _body(_inner(**{"while": {
        "count": 2, "rtol": 1e-3}})),
    "inner_count_not_scalar": _body(_inner(**{"while": {"count": "r0"}})),
    "inner_count_uses_inner_value": _body(_inner(**{"while": {
        "count": "h"}})),
    "inner_in_cond": _body({"cond": {
        "if": "rnorm0 <= 1", "then": [_inner(yield_={"hf": "h"})],
        "else": [{"let": {"hf": "rnorm0"}}]}}),
    "inner_feedback_kind": _body(_inner(feedback={"h": "r0"})),
    "inner_matrix_feedback": _body(_inner(
        state={"h": {"init": "r0"}}, body=[{"let": {"h2": "A"}}])),
    "inner_metric_not_produced": _body(_inner(**{"while": {
        "metric": "rnorm0", "max_iters": 3}})),
    "inner_metric_not_scalar": _body(_inner(
        state={"h": {"init": "r0"}}, body=[{"let": {"h2": "h"}}],
        **{"while": {"metric": "h2", "max_iters": 3}})),
    "inner_init_not_scalar": _body(_inner(**{"while": {
        "metric": "h2", "init": "r0", "max_iters": 3}})),
    "inner_scale_not_scalar": _body(_inner(**{"while": {
        "metric": "h2", "init": "rnorm0", "scale": "r0",
        "max_iters": 3}})),
    "inner_yield_rebinds": _body(_inner(yield_={"r0": "h"})),
    "inner_store_outer_stack": _body(_inner(body=[
        {"let": {"h2": "h * 0.5"}},
        {"store": {"into": "S", "slot": "0", "value": "h2"}}]), S=_S3),
    "inner_stack_slot0_kind": _body(_inner(state={
        "h": {"init": "rnorm0"},
        "T": _stack(slots=2, of="vector", init={"slot0": "rnorm0"})})),
    "stack_into_scalar_port": _body(
        {"program": specs.NRM2, "inputs": {"x": "S"},
         "outputs": {"norm": "nn"}}, S=_V3),
})
for case in [k for k in BROKEN if k.startswith("inner_")]:
    # "yield" is a Python keyword: _inner takes it as yield_
    stage = BROKEN[case]["iterate"]["body"][0]
    for target in ([stage] + stage.get("cond", {}).get("then", [])):
        it = target.get("iterate", {})
        if "yield_" in it:
            it["yield"] = it.pop("yield_")


@pytest.mark.parametrize("max_iters", [5, 1000])
def test_unguarded_loop_matches_reference(max_iters):
    """A loop spec without a guards section runs the ungated loop
    (converged, or out of budget), as in the reference."""
    raw = {**specs.JACOBI_LOOP, "iterate": {
        k: v for k, v in specs.JACOBI_LOOP["iterate"].items()
        if k != "guards"}}
    ops = _operands("JACOBI_LOOP", seed=5)
    got = LoopProgram(raw, max_iters=max_iters, device="cpu").solve(
        **inputs_from_numpy(ops, device="cpu"))
    want = JLoopProgram(raw, max_iters=max_iters).solve(
        **{k: jnp.asarray(v) for k, v in ops.items()})
    _assert_same_solve(got, want)
    assert got.status_names() == ("MAX_ITERS" if max_iters == 5
                                  else "CONVERGED")


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_loop_spec_errors_match_reference(case):
    with pytest.raises(JSpecError) as want:
        jlowering.lower_loop(BROKEN[case], verify=False)
    with pytest.raises(SpecError) as got:
        lowering.lower_loop(BROKEN[case], device="cpu", verify=False)
    assert (got.value.code, got.value.path) == (want.value.code,
                                                want.value.path)
    assert str(got.value) == str(want.value)
