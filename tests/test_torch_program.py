"""Port parity for the whole slice: spec, graph, fusion plan, generated
group, lowering and runtime. The same seeded numpy inputs go through the
reference package's `Program` (Pallas in interpret mode) and through
repro_torch's `Program` on the CPU.

Tolerances: reductions rtol=1e-5, atol=1e-2*sqrt(n), as the reference's
own program tests use (tests/test_core_program.py:129); element-wise
float32 outputs 1e-6 relative to their scale.
"""
import numpy as np
import pytest
import torch

from repro.core import Program as JProgram, fusion as jfusion, \
    spec as jspec
from repro.core.graph import DataflowGraph as JGraph
from repro.solvers import specs as jsolver_specs
from repro_torch.core import (AXPY_SPEC, AXPYDOT_SPEC, GEMV_SPEC, Program,
                              codegen, fusion, lowering, spec as tspec)
from repro_torch.core.expr import parse_expr, parse_pred
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.runtime import inputs_from_numpy, results_to_numpy
from repro_torch.kernels import common, ops as tops, window

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)

MODES = ["dataflow", "nodataflow", "reference"]


def _np_inputs(names_shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s).astype(np.float32) if s else
                float(rng.uniform(-1, 1)))
            for k, s in names_shapes.items()}


def _run_both(raw, mode, inputs, ref_mode=None):
    want = JProgram.from_spec(raw, mode=ref_mode or mode)(**inputs)
    got = Program.from_spec(raw, mode=mode, device="cpu")(
        **inputs_from_numpy(inputs, device="cpu"))
    return results_to_numpy(got), {k: np.asarray(v) for k, v in
                                   want.items()}


# ---------------------------------------------------------------------------
# AXPYDOT_SPEC end to end, all three modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 1000, 10_000])
@pytest.mark.parametrize("mode", MODES)
def test_axpydot_program_matches_reference(mode, n):
    inputs = _np_inputs({"w": (n,), "v": (n,), "u": (n,),
                         "neg_alpha": ()}, seed=n)
    got, want = _run_both(AXPYDOT_SPEC, mode, inputs)
    assert set(got) == set(want) == {"beta"}
    np.testing.assert_allclose(got["beta"], want["beta"], rtol=1e-5,
                               atol=1e-2 * np.sqrt(n))


@pytest.mark.parametrize("mode", MODES)
def test_axpy_program_matches_reference(mode):
    inputs = _np_inputs({"x": (1000,), "y": (1000,), "alpha": ()}, seed=5)
    got, want = _run_both(AXPY_SPEC, mode, inputs)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-6,
                               atol=1e-6 * 4)


# ---------------------------------------------------------------------------
# Generated level-1 groups
# ---------------------------------------------------------------------------

# waxpby -> scal -> {dot, nrm2, iamax}, the scaled vector also public
# (the shape of tests/test_core_program.py:134, plus iamax)
WIDE_SPEC = {"name": "wide", "routines": [
    {"blas": "waxpby", "name": "wx", "scalars": {"alpha": 0.5, "beta": 2.0},
     "inputs": {"x": "x", "y": "y"}, "connections": {"out": "sc.x"}},
    {"blas": "scal", "name": "sc", "scalars": {"alpha": {"input": "a"}},
     "connections": {"out": ["dd.x", "nn.x", "im.x"]},
     "outputs": {"out": "s"}},
    {"blas": "dot", "name": "dd", "inputs": {"y": "x"},
     "outputs": {"out": "d"}},
    {"blas": "nrm2", "name": "nn", "outputs": {"out": "r"}},
    {"blas": "iamax", "name": "im", "outputs": {"out": "idx"}},
]}

# copy -> rot -> {vmul, iamax} (tests/test_kernels_blas.py:248)
ROT_SPEC = {"name": "rotchain", "routines": [
    {"blas": "copy", "name": "cp", "inputs": {"x": "x"},
     "connections": {"out": "g.x"}},
    {"blas": "rot", "name": "g", "scalars": {"c": 0.6, "s": 0.8},
     "inputs": {"y": "y"},
     "connections": {"out_x": ["h.x", "im.x"], "out_y": "h.y"},
     "outputs": {"out_y": "yr"}},
    {"blas": "vmul", "name": "h", "outputs": {"out": "prod"}},
    {"blas": "iamax", "name": "im", "outputs": {"out": "idx"}},
]}

# vsub and vdiv splice into a group; asum sums its output
VSUB_SPEC = {"name": "vsubdiv", "routines": [
    {"blas": "vsub", "name": "sub", "inputs": {"x": "x", "y": "y"},
     "connections": {"out": "dv.x"}},
    {"blas": "vdiv", "name": "dv", "inputs": {"y": "d"},
     "connections": {"out": "as.x"}, "outputs": {"out": "q"}},
    {"blas": "asum", "name": "as", "outputs": {"out": "total"}},
]}

GROUP_SPECS = {"wide": WIDE_SPEC, "rot": ROT_SPEC, "vsub": VSUB_SPEC}


def _group_inputs(name, n, seed):
    shapes = {"x": (n,), "y": (n,)}
    if name == "wide":
        shapes["a"] = ()
    inputs = _np_inputs(shapes, seed)
    if name == "vsub":
        inputs["d"] = (np.random.default_rng(seed + 1).uniform(1, 2, n)
                       .astype(np.float32))
    return inputs


@pytest.mark.parametrize("n", [128, 1000, 10_000])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(GROUP_SPECS))
def test_group_program_matches_reference(name, mode, n):
    # The reference's generated group pads the tail with zeros and sums
    # the padded lanes too: vdiv makes them 0/0 = NaN, so its dataflow
    # `total` is NaN whenever n is not a multiple of 128 (ROADMAP
    # Queue 3). The port masks the tail; it is held to the reference's
    # unfused result there.
    ref_mode = "nodataflow" if (name, mode) == ("vsub", "dataflow") \
        else mode
    got, want = _run_both(GROUP_SPECS[name], mode,
                          _group_inputs(name, n, seed=n + 11), ref_mode)
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "idx":
            assert int(got[key]) == int(w)
        elif np.ndim(w) == 0:
            np.testing.assert_allclose(got[key], w, rtol=1e-5,
                                       atol=1e-2 * np.sqrt(n))
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("name", sorted(GROUP_SPECS) + ["axpydot"])
def test_dataflow_plans_one_generated_group(name):
    raw = GROUP_SPECS.get(name, AXPYDOT_SPEC)
    prog = Program.from_spec(raw, device="cpu")
    assert len(prog.groups) == 1 and prog.groups[0].fused


def _fused_level1_groups():
    """Every fused level-1 group of every shipped and test spec."""
    out = []
    for label, raw in _all_program_specs() + list(GROUP_SPECS.items()):
        ir = lowering.lower(raw, upto="fuse")
        for gi, g in enumerate(ir.groups):
            if g.fused and g.anchor is None:
                out.append((f"{label}:g{gi}", ir.graph, g))
    return out


def test_generated_group_sources_compile_as_python():
    groups = _fused_level1_groups()
    assert len(groups) >= 10
    for label, graph, group in groups:
        sig = codegen._group_signature(graph, group)
        body = codegen.group_body(graph, group, sig)
        src = window.source(body)
        compile(src, f"<{label}>", "exec")
        assert len(body.stores) == len(sig.elt_out_keys)
        assert len(body.sums) + len(body.argmaxes) == len(sig.red_out_keys)


# ---------------------------------------------------------------------------
# Dispatch structure, through the plain-call counters
# ---------------------------------------------------------------------------


def _counts():
    return (codegen.group_kernel.plain_calls, tops.axpy.plain_calls,
            tops.dot.plain_calls)


@pytest.mark.parametrize("mode,expected", [
    ("dataflow", (1, 0, 0)), ("nodataflow", (0, 1, 1)),
    ("reference", (0, 0, 0))])
def test_axpydot_dispatch_structure(mode, expected):
    inputs = inputs_from_numpy(_np_inputs(
        {"w": (512,), "v": (512,), "u": (512,), "neg_alpha": ()}, seed=1),
        device="cpu")
    prog = Program.from_spec(AXPYDOT_SPEC, mode=mode, device="cpu")
    common.reset_counts(codegen.group_kernel, *tops.KERNELS.values())
    prog(**inputs)
    assert _counts() == expected
    assert codegen.group_kernel.launches == 0


# ---------------------------------------------------------------------------
# Fusion plans equal the reference's for every shipped spec
# ---------------------------------------------------------------------------


def _stage_programs(stages, where):
    out = []
    for i, st in enumerate(stages):
        here = f"{where}[{i}]"
        if isinstance(st, tspec.ProgramStage):
            out.append((here, st.raw_program))
        elif isinstance(st, tspec.CondStage):
            out += _stage_programs(st.then, f"{here}.then")
            out += _stage_programs(st.orelse, f"{here}.else")
        elif isinstance(st, tspec.InnerLoopStage):
            out += _stage_programs(st.body, f"{here}.body")
    return out


def _all_program_specs():
    """(label, raw program spec) for the three runtime specs and every
    program in repro.solvers.specs, loop bodies included."""
    out = [("AXPYDOT_SPEC", AXPYDOT_SPEC), ("AXPY_SPEC", AXPY_SPEC),
           ("GEMV_SPEC", GEMV_SPEC)]
    for name in sorted(vars(jsolver_specs)):
        raw = getattr(jsolver_specs, name)
        if not name.isupper() or not isinstance(raw, dict):
            continue
        if tspec.is_loop_spec(raw):
            ls = tspec.parse_loop(raw)
            out += [(f"{name}.{w}", p) for w, p in
                    _stage_programs(ls.setup, "setup")
                    + _stage_programs(ls.body, "body")]
        else:
            out.append((name, raw))
    return out


def _plan_shape(groups):
    return [(list(g.nodes), g.anchor, g.fused) for g in groups]


@pytest.mark.parametrize("fuse,anchor", [(True, True), (True, False),
                                         (False, False)])
def test_fusion_plans_match_reference(fuse, anchor):
    specs = _all_program_specs()
    assert len(specs) > 30
    kinds = set()
    for label, raw in specs:
        want = jfusion.plan(JGraph(jspec.parse(raw)), enable=fuse,
                            anchor=anchor)
        got = fusion.plan(DataflowGraph(tspec.parse(raw)), enable=fuse,
                          anchor=anchor)
        assert _plan_shape(got) == _plan_shape(want), label
        kinds |= {("tiled" if g.anchor and "gemm" in g.anchor else
                   "anchored" if g.anchor else
                   "fused" if g.fused else "single") for g in got}
    if fuse and anchor:
        # the comparison covers the plans the port cannot run yet
        assert {"anchored", "fused", "single"} <= kinds


def test_loop_specs_round_trip_like_the_reference():
    for name in sorted(vars(jsolver_specs)):
        raw = getattr(jsolver_specs, name)
        if name.isupper() and tspec.is_loop_spec(raw):
            assert tspec.unparse_loop(tspec.parse_loop(raw)) == \
                jspec.unparse_loop(jspec.parse_loop(raw)), name


# ---------------------------------------------------------------------------
# Spec errors: same codes and paths as the reference
# ---------------------------------------------------------------------------

BROKEN = {
    "unknown_routine": {"routines": [{"blas": "nosuch"}]},
    "bad_target_port": {"routines": [
        {"blas": "axpy", "name": "a", "connections": {"out": "b.nope"}},
        {"blas": "dot", "name": "b"}]},
    "scalar_feeds_window": {"routines": [
        {"blas": "dot", "name": "d", "connections": {"out": "a.x"}},
        {"blas": "axpy", "name": "a"}]},
    "cycle": {"routines": [
        {"blas": "axpy", "name": "a", "connections": {"out": "b.x"}},
        {"blas": "axpy", "name": "b", "connections": {"out": "a.x"}}]},
    "driven_twice": {"routines": [
        {"blas": "axpy", "name": "a", "connections": {"out": "c.x"}},
        {"blas": "axpy", "name": "b", "connections": {"out": "c.x"}},
        {"blas": "dot", "name": "c"}]},
    "vector_width": {"vector_width": 64, "routines": [{"blas": "axpy"}]},
    "bad_dtype": {"dtype": "int8", "routines": [{"blas": "axpy"}]},
    "no_routines": {"routines": []},
}


def _spec_error(spec_mod, graph_cls, raw):
    with pytest.raises(spec_mod.SpecError) as ei:
        graph_cls(spec_mod.parse(raw))
    return ei.value


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_spec_errors_match_reference(case):
    want = _spec_error(jspec, JGraph, BROKEN[case])
    got = _spec_error(tspec, DataflowGraph, BROKEN[case])
    assert (got.code, got.path) == (want.code, want.path)
    if case != "vector_width":   # the port's message names no TPU unit
        assert str(got) == str(want)


# ---------------------------------------------------------------------------
# ger and transpose programs, device rule, data carried across
# ---------------------------------------------------------------------------

# one-routine programs of the last two level-2 kernels (CUDA C++ on the
# card, their plain versions here)
GER_SPEC = {"routines": [
    {"blas": "ger", "name": "r1", "scalars": {"alpha": {"input": "alpha"}},
     "inputs": {"x": "x", "y": "y", "A": "A"}, "outputs": {"out": "out"}}]}
TRANSPOSE_SPEC = {"routines": [
    {"blas": "transpose", "name": "tr", "inputs": {"A": "A"},
     "outputs": {"out": "out"}}]}


def _matrix_program_inputs(raw, shape, seed):
    names = {"A": shape, "x": (shape[0],), "y": (shape[1],), "alpha": ()} \
        if raw is GER_SPEC else {"A": shape}
    return _np_inputs(names, seed)


@pytest.mark.parametrize("raw,mode", [
    (GER_SPEC, "dataflow"), (TRANSPOSE_SPEC, "dataflow"),
    (GER_SPEC, "nodataflow"), (TRANSPOSE_SPEC, "nodataflow"),
    (GER_SPEC, "reference"), (TRANSPOSE_SPEC, "reference")])
def test_unported_kernels_raise_outside_reference(raw, mode):
    """GER_SPEC and TRANSPOSE_SPEC lower in every mode and match the
    reference's Program in the same mode: ger within two float32
    roundings of its terms, transpose exactly. Outside reference mode
    each is one standalone group that calls its kernel's wrapper."""
    prog = Program.from_spec(raw, mode=mode, device="cpu")
    assert [g.nodes for g in prog.groups] == [[raw["routines"][0]["name"]]]
    for shape, seed in (((20, 21), 1), ((24, 40), 4)):
        inputs = _matrix_program_inputs(raw, shape, seed)
        wrapper = tops.ger if raw is GER_SPEC else tops.transpose
        before = wrapper.plain_calls
        got, want = _run_both(raw, mode, inputs)
        assert wrapper.plain_calls == before + (mode != "reference")
        if raw is TRANSPOSE_SPEC:
            np.testing.assert_array_equal(got["out"], want["out"])
            np.testing.assert_array_equal(got["out"], inputs["A"].T)
            continue
        terms = np.abs(inputs["alpha"] * np.outer(inputs["x"], inputs["y"])) \
            + np.abs(inputs["A"])
        assert np.all(np.abs(got["out"] - want["out"]) <= 2.0 ** -23 * terms)


def test_unported_routines_run_in_reference_mode():
    inputs = _np_inputs({"A": (24, 40), "x": (24,), "y": (40,),
                         "alpha": ()}, seed=4)
    got, want = _run_both(GER_SPEC, "reference", inputs)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                               atol=1e-5)


def test_program_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Program.from_spec(AXPYDOT_SPEC)


def test_program_rejects_inputs_on_another_device():
    prog = Program.from_spec(AXPYDOT_SPEC, device="cpu")
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="program runs on cpu"):
        prog(neg_alpha=-1.0, w=meta, v=meta, u=meta)


def test_mismatched_lengths_raise_in_fused_group():
    prog = Program.from_spec(AXPYDOT_SPEC, device="cpu")
    with pytest.raises(ValueError, match="disagree on length"):
        prog(neg_alpha=-1.0, w=torch.zeros(128), v=torch.zeros(128),
             u=torch.zeros(256))


def test_synthetic_inputs_match_reference():
    sizes = {"w": (1024,), "v": (1024,), "u": (1024,), "neg_alpha": ()}
    want = JProgram.from_spec(AXPYDOT_SPEC).synthetic_inputs(sizes)
    got = Program.from_spec(AXPYDOT_SPEC, device="cpu").synthetic_inputs(
        sizes)
    for k in sizes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_bf16_inputs_round_trip_through_numpy():
    import jax.numpy as jnp

    a = np.random.default_rng(0).standard_normal(100).astype(np.float32)
    jb = np.asarray(jnp.asarray(a, dtype=jnp.bfloat16))
    t = inputs_from_numpy({"x": jb, "s": np.float32(0.5)}, device="cpu")
    assert t["x"].dtype == torch.bfloat16 and t["s"].dtype == torch.float32
    np.testing.assert_array_equal(results_to_numpy(t)["x"],
                                  jb.astype(np.float32))


def test_describe_and_jitted():
    prog = Program.from_spec(AXPYDOT_SPEC, device="cpu")
    assert "FUSED" in prog.describe() and "zcalc" in prog.describe()
    x = torch.ones(300)
    assert float(prog.jitted()(neg_alpha=-1.0, w=x, v=x, u=x)["beta"]) == 0.0


EXPRS = ["rz / pq", "-(a + 2.5) * b", "sqrt(abs(a - b)) / 0",
         "1.5e1 - a * (b / a)"]


@pytest.mark.parametrize("src", EXPRS)
def test_scalar_expressions_match_reference(src):
    from repro.core.expr import parse_expr as jparse

    env = {"rz": 3.0, "pq": 0.0, "a": -1.25, "b": 4.0}
    want = jparse(src).evaluate({k: np.float32(v) for k, v in env.items()})
    got = parse_expr(src).evaluate(
        {k: torch.tensor(v) for k, v in env.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert parse_pred(f"{src} <= 1").names == parse_expr(src).names


def test_compile_cached_lowers_once_per_configuration():
    a = Program.from_spec(AXPYDOT_SPEC, device="cpu")
    b = Program.from_spec(dict(AXPYDOT_SPEC), device="cpu")
    c = Program.from_spec(AXPYDOT_SPEC, mode="nodataflow", device="cpu")
    assert a.ir is b.ir and a.ir is not c.ir
    assert lowering.cache_stats() == {"hits": 1, "misses": 2, "size": 2}
    assert a.ir.passes_run == ["parse", "graph", "infer", "fuse", "place",
                               "emit"]
    # tiles="auto" (a refusal naming ROADMAP Queue 1, item 12 until the
    # tuner was ported) resolves a cold table to the empty plan
    assert not lowering.lower(AXPYDOT_SPEC, device="cpu",
                              tiles="auto").tile_plan
