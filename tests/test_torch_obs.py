"""Port parity for `repro_torch.obs` against `repro.obs`: the registry's
semantics, the JSONL export and CLI, and the instrumentation threaded
through lowering, fusion, codegen and the loop driver. Mirrors
tests/test_obs.py and holds the two packages' record streams to each
other.

What must agree with the reference, on the CPU: the same spec lowered,
fused and run through both packages under `capture()` gives the same
sequence of record kinds, names, nesting paths and non-timing
attributes, compared exactly (the digests are the same content hash).
Both packages compile with their static analyzers on and `tiles="auto"`
over fresh, empty tuning tables, so the `verify.*` and `tune.cache.*`
records are held to each other too. A loop solve differs in
one documented way: the reference runs the solve under `jax.jit`, where
no `kernel.group` span is taken (it would time a trace), while the port
runs each stage program eagerly and takes one per group launch; those
spans are counted separately and left out of the comparison. A solve's
`final_residual` is not compared between the packages: both must lie
below the stop threshold with the same iteration count, since float32
sums in another order can move the last iteration's residual by more
than its own size.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jblas, obs as jobs
from repro.core import AXPYDOT_SPEC as J_AXPYDOT_SPEC
from repro.core import Program as JProgram, lowering as jlowering
from repro.solvers import specs as jspecs
from repro_torch import blas, obs
from repro_torch.core import AXPYDOT_SPEC, Program
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.solvers import LoopProgram, specs

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

CPU = "cpu"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


# uniquely named copies of the canonical anchored chain (a cached
# compile skips the pipeline entirely and so emits no spans or events)
def _gemv_chain(name):
    return {
        "name": name,
        "routines": [
            {"blas": "gemv", "name": "mv",
             "scalars": {"alpha": 1.0, "beta": 0.0},
             "inputs": {"A": "A", "x": "p", "y": "y0"},
             "connections": {"out": "up.x"}, "outputs": {"out": "q"}},
            {"blas": "axpy", "name": "up",
             "scalars": {"alpha": {"input": "neg_alpha"}},
             "inputs": {"y": "r"},
             "connections": {"out": "rn.x"},
             "outputs": {"out": "r_next"}},
            {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}},
        ],
    }


# a gemv whose output feeds both a dot and a second gemv's x: the
# planner absorbs the dot and rejects the gemv consumer
# ("member-not-fusable"), so the reject path is covered too
_REJECT_CHAIN = {
    "name": "obs_reject_chain",
    "routines": [
        {"blas": "gemv", "name": "mv1",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "y"},
         "connections": {"out": ["d.x", "mv2.x"]}},
        {"blas": "dot", "name": "d", "inputs": {"y": "x"},
         "outputs": {"out": "s"}},
        {"blas": "gemv", "name": "mv2",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "y": "y"}, "outputs": {"out": "z"}},
    ],
}

N = 16


def _chain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"A": rng.standard_normal((N, N)).astype(np.float32),
            "p": rng.standard_normal(N).astype(np.float32),
            "y0": rng.standard_normal(N).astype(np.float32),
            "r": rng.standard_normal(N).astype(np.float32),
            "neg_alpha": np.float32(-0.5)}


def _spd(n=N, seed=1):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def _t(inputs):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                and v.ndim else float(v)) for k, v in inputs.items()}


def _j(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


# the port's own loop-driver records, which the reference does not take
_LOOP_RECORDS = ("loop.iter", "loop.stop", "loop.stage", "loop.iterations")


def _strip(recs, drop=()):
    """(kind, name, n, path, non-timing attrs) per record."""
    out = []
    for r in recs:
        if r["name"] in drop:
            continue
        attrs = dict(r.get("attrs", {}))
        attrs.pop("final_residual", None)
        out.append((r["kind"], r["name"], r.get("n"), r.get("path"),
                    json.dumps(attrs, sort_keys=True, default=repr)))
    return out


# ---------------------------------------------------------------------------
# Registry core
# ---------------------------------------------------------------------------


def test_disabled_by_default_records_nothing():
    assert not obs.enabled()
    assert obs.span("x") is obs.NULL_SPAN
    obs.counter("c")
    obs.event("e")
    assert obs.records() == []
    assert obs.counters() == {}


def test_span_counter_event_record_shapes():
    with obs.capture() as reg:
        with obs.span("outer", program="p"):
            with obs.span("inner"):
                pass
            obs.counter("hits", 2, mode="dataflow")
            obs.event("decided", reason="because")
        recs = list(reg.records)
    inner, ctr, evt, outer = recs       # spans record on exit
    assert inner["kind"] == "span" and inner["name"] == "inner"
    assert inner["path"] == "outer/inner"       # nesting is recorded
    assert inner["dur_s"] >= 0.0
    assert outer["name"] == "outer"
    assert outer["attrs"] == {"program": "p"}
    assert outer["dur_s"] >= inner["dur_s"]
    assert ctr == {"kind": "counter", "name": "hits", "n": 2,
                   "attrs": {"mode": "dataflow"}}
    assert evt["kind"] == "event" and evt["name"] == "decided"
    assert evt["attrs"] == {"reason": "because"}
    assert reg.counters == {"hits": 2}


def test_capture_is_scoped():
    with obs.capture() as inner_reg:
        obs.event("inside")
        assert obs.enabled()
        assert len(inner_reg.records) == 1
    assert not obs.enabled()        # outer (disabled) registry restored
    assert obs.records() == []      # nothing leaked


def test_enable_disable_reset():
    obs.enable()
    try:
        obs.event("a")
        obs.counter("c")
        assert len(obs.records()) == 2
        obs.reset()
        assert obs.records() == [] and obs.counters() == {}
    finally:
        obs.disable()
        obs.reset()


def test_registries_are_independent():
    """Recording in one package never shows in the other: both are
    process-global, and the port's tests share workers with the JAX
    tests."""
    with obs.capture() as reg:
        assert not jobs.enabled()
        jobs.event("reference-only")
        obs.event("port-only")
        blas.dot(torch.ones(4), torch.ones(4), device=CPU)
    assert [r["name"] for r in reg.records if r["kind"] == "event"
            and r["name"] == "port-only"] == ["port-only"]
    assert jobs.records() == [] and obs.records() == []
    with jobs.capture() as jreg:
        assert not obs.enabled()
        obs.event("port-only")
    assert jreg.records == [] and obs.records() == []


def test_concrete_and_block_on_the_cpu():
    """Outside a CUDA-graph capture everything is concrete; a CPU
    tensor needs no wait, so `block` returns at once."""
    assert obs.concrete([torch.ones(2)])
    assert obs.concrete()
    obs.block([torch.ones(2), 3.0, None])


# ---------------------------------------------------------------------------
# JSONL export + CLI
# ---------------------------------------------------------------------------


def _write_jsonl(tmp_path):
    with obs.capture() as reg:
        with obs.span("work", stage="s"):
            obs.counter("widgets", 3)
        obs.event("done", ok=True)
        path = reg.export_jsonl(tmp_path / "trace.jsonl")
    return path


def test_jsonl_roundtrip_and_summary(tmp_path):
    path = _write_jsonl(tmp_path)
    recs = obs.load_jsonl(path)
    assert [r["kind"] for r in recs] == ["counter", "span", "event"]
    s = obs.summarize_records(recs)
    assert s["spans"]["work"]["count"] == 1
    assert s["counters"]["widgets"] == 3
    assert s["events"]["done"] == 1
    assert "work" in obs.format_summary(s)
    # the same file summarizes identically through the reference
    assert jobs.summarize_records(jobs.load_jsonl(path)) == s


def test_cli_summarize_trace_diff(tmp_path, capsys):
    path = str(_write_jsonl(tmp_path))
    assert obs_cli(["summarize", path]) == 0
    out = capsys.readouterr().out
    assert "work" in out and "widgets" in out
    assert obs_cli(["trace", path, "--kind", "span", "--limit", "5"]) == 0
    assert "[span] work" in capsys.readouterr().out
    assert obs_cli(["diff", path, path]) == 0
    assert "B/A" in capsys.readouterr().out


def test_env_var_records_the_process_and_writes_jsonl(tmp_path):
    """REPRO_TORCH_OBS_JSONL turns recording on for a whole process and
    writes the file at exit; the reference's variable stays its own."""
    path = tmp_path / "env.jsonl"
    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_TORCH_OBS_JSONL=str(path))
    env.pop("REPRO_OBS_JSONL", None)
    code = ("import torch\n"
            "from repro_torch import blas, obs\n"
            "assert obs.enabled()\n"
            "blas.axpy(0.5, torch.ones(8), torch.ones(8), device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = {r["name"] for r in obs.load_jsonl(path)}
    assert {"lowering.emit", "lowering.done", "kernel.group",
            "lowering.cache.miss"} <= names


# ---------------------------------------------------------------------------
# Pipeline instrumentation: lowering spans, cache counters, fusion
# decisions, codegen group tags
# ---------------------------------------------------------------------------


def test_lowering_spans_and_cache_counters():
    spec = _gemv_chain("obs_probe_lowering")
    with obs.capture() as reg:
        blas.compile(spec, device=CPU)           # miss: full pipeline
        blas.compile(spec, device=CPU)           # hit: cached IR
        recs = list(reg.records)
        ctrs = dict(reg.counters)
    span_names = {r["name"] for r in recs if r["kind"] == "span"}
    assert {"lowering.parse", "lowering.graph", "lowering.infer",
            "lowering.fuse", "lowering.place",
            "lowering.emit"} <= span_names
    assert ctrs.get("lowering.cache.miss", 0) == 1
    assert ctrs.get("lowering.cache.hit", 0) == 1
    done = [r for r in recs if r["kind"] == "event"
            and r["name"] == "lowering.done"]
    assert len(done) == 1                        # once per fresh lower
    assert done[0]["attrs"]["program"] == "obs_probe_lowering"


def test_fusion_decision_events():
    """The anchored chain absorbs its level-1 consumers: the planner's
    reasoning surfaces as one decision event per anchor candidate."""
    with obs.capture() as reg:
        blas.compile(_gemv_chain("obs_probe_fusion"), device=CPU)
        evts = [r for r in reg.records if r["kind"] == "event"
                and r["name"] in ("fusion.absorb", "fusion.reject")]
    absorbs = [e for e in evts if e["name"] == "fusion.absorb"]
    assert absorbs, "gemv anchor must absorb its axpy/nrm2 consumers"
    for e in evts:
        a = e["attrs"]
        assert a["program"] == "obs_probe_fusion"
        assert a["anchor"] == "mv"
        assert a["direction"] in ("down", "up")
        if e["name"] == "fusion.reject":
            assert a["reason"]


def test_codegen_group_events_tag_every_group():
    with obs.capture() as reg:
        exe = blas.compile(_gemv_chain("obs_probe_codegen"), device=CPU)
        evts = [r for r in reg.records if r["kind"] == "event"
                and r["name"] == "codegen.group"]
    assert len(evts) == len(exe._impl.ir.groups)
    kinds = {e["attrs"]["kind"] for e in evts}
    assert "anchored" in kinds                  # the gemv group
    anchored = [e for e in evts if e["attrs"]["kind"] == "anchored"]
    assert anchored[0]["attrs"]["anchor"] == "mv"
    assert "mv" in anchored[0]["attrs"]["routines"]


_PROGRAMS = {
    "gemv_chain": (_gemv_chain("obs_parity_chain"), _chain_inputs),
    "axpydot": (None, lambda: {
        k: np.random.default_rng(7).standard_normal(N).astype(np.float32)
        for k in ("v", "w", "u")} | {"neg_alpha": np.float32(-0.7)}),
    "reject_chain": (_REJECT_CHAIN, lambda: {
        "A": np.random.default_rng(8).standard_normal(
            (N, N)).astype(np.float32),
        "x": np.random.default_rng(9).standard_normal(N).astype(
            np.float32),
        "y": np.zeros(N, np.float32)}),
}


@pytest.fixture
def empty_tables(monkeypatch, tmp_path):
    """Fresh, empty tuning tables for both packages, so `tiles="auto"`
    resolves cold in both and writes nowhere else."""
    from repro.tune import store as jstore
    from repro_torch.tune import store as tstore

    monkeypatch.setenv(jstore.ENV_CACHE_DIR, str(tmp_path / "jax"))
    monkeypatch.setenv(tstore.ENV_CACHE_DIR, str(tmp_path / "torch"))
    jstore.reset_store()
    tstore.reset_store()
    yield
    monkeypatch.undo()
    jstore.reset_store()
    tstore.reset_store()


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow", "reference"])
@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_program_records_equal_reference(name, mode, empty_tables):
    """Verification, tile resolution, lowering, fusion, codegen and one
    call of the same spec give the same record stream in both packages,
    `verify.*` records and `kernel.group` spans included (the
    reference's `Program` call runs eagerly too). Both compile with
    their analyzers on and `tiles="auto"` over empty tables."""
    raw, make_inputs = _PROGRAMS[name]
    raw_t = AXPYDOT_SPEC if raw is None else raw
    raw_j = J_AXPYDOT_SPEC if raw is None else raw
    inputs = make_inputs()
    with jobs.capture() as jreg:
        JProgram.from_ir(jlowering.compile_cached(
            raw_j, mode=mode, tiles="auto", verify=True))(**_j(inputs))
    with obs.capture() as reg:
        Program.from_spec(raw_t, mode=mode, device=CPU)(**_t(inputs))
    want, got = _strip(jreg.records), _strip(reg.records)
    assert got == want
    assert any(r[1] == "verify.done" for r in got)
    if name == "reject_chain" and mode == "dataflow":
        assert {r[1] for r in got} >= {"fusion.absorb", "fusion.reject"}


# ---------------------------------------------------------------------------
# Solver telemetry
# ---------------------------------------------------------------------------


def _cg_ops(n=N):
    return {"A": np.eye(n, dtype=np.float32) * 2.0,
            "b": np.ones(n, np.float32),
            "x0": np.zeros(n, np.float32)}


def test_solver_result_event_and_history_trimmed():
    exe = blas.compile(specs.CG_LOOP, max_iters=8, device=CPU)
    with obs.capture() as reg:
        res = exe.run(**_t(_cg_ops()))
        evts = [r for r in reg.records if r["kind"] == "event"
                and r["name"] == "solver.result"]
    assert len(evts) == 1
    a = evts[0]["attrs"]
    assert a["program"] == "cg"
    assert a["iterations"] == int(res.iterations)
    assert a["converged"] == bool(res.converged)
    assert a["status"] == res.status_names()
    assert a["final_residual"] == pytest.approx(float(res.residual))
    # history_trimmed drops the NaN tail past the stopping point
    trimmed = res.history_trimmed()
    assert len(trimmed) == int(res.iterations) + 1
    assert not np.isnan(trimmed).any()
    assert int(torch.isnan(res.history).sum()) == \
        len(res.history) - len(trimmed)


def test_solver_result_event_batched():
    """tests/test_obs.py:221: a batched solve is one `solver.solve` span
    marked batched and one `solver.result` event with per-lane lists,
    equal to the reference's but for the residuals' last digits."""
    n, nrhs = 16, 3
    A = np.eye(n, dtype=np.float32) * 2.0
    B = np.stack([np.full(n, v, np.float32) for v in (1.0, 2.0, 3.0)])
    ops = {"A": A, "b": B, "x0": np.zeros_like(B)}
    with obs.capture() as reg:
        res = blas.compile(specs.CG_LOOP, max_iters=8, device=CPU).batched(
            axes={"A": None}, **_t(ops))
    with jobs.capture() as jreg:
        jblas.compile(jspecs.CG_LOOP, max_iters=8).batched(
            axes={"A": None}, **_j(ops))
    evts = [r for r in reg.records if r["name"] == "solver.result"]
    jevts = [r for r in jreg.records if r["name"] == "solver.result"]
    assert len(evts) == len(jevts) == 1
    a, ja = evts[0]["attrs"], jevts[0]["attrs"]
    assert a["batch"] == ja["batch"] == nrhs
    assert a["iterations"] == ja["iterations"] == \
        [int(k) for k in res.iterations]
    assert a["converged"] == ja["converged"] == \
        [bool(c) for c in res.converged]
    assert a["status"] == ja["status"] == res.status_names()
    np.testing.assert_allclose(a["final_residual"], ja["final_residual"],
                               rtol=1e-5, atol=1e-6)
    spans = [r for r in reg.records if r["name"] == "solver.solve"]
    assert len(spans) == 1 and spans[0]["attrs"]["batched"] is True
    trimmed = res.history_trimmed()
    assert len(trimmed) == nrhs
    for lane, k in enumerate(res.iterations):
        assert len(trimmed[lane]) == int(k) + 1
        assert not np.isnan(trimmed[lane]).any()


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
def test_cg_solve_records_equal_reference(mode, empty_tables):
    """A CG solve's records (the loop spec's verification, its stage
    programs' tile resolution and lowering, the build, the solve span
    and the result event) equal the reference's once the port's
    per-launch `kernel.group` spans are set aside; those number one per
    group launch: the setup's programs once, the body's once an
    iteration. Both compile with their analyzers on and `tiles="auto"`
    over empty tables."""
    a, b = _spd(), np.random.default_rng(2).standard_normal(N).astype(
        np.float32)
    ops = {"A": a, "b": b, "x0": np.zeros(N, np.float32)}
    with jobs.capture() as jreg:
        jexe = jblas.compile(jspecs.CG_LOOP, mode=mode, max_iters=100,
                             tiles="auto", verify=True)
        jres = jexe.run(tol=1e-6, **_j(ops))
    with obs.capture() as reg:
        exe = blas.compile(specs.CG_LOOP, mode=mode, max_iters=100,
                           device=CPU)
        res = exe.run(tol=1e-6, **_t(ops))
    assert _strip(reg.records, drop=("kernel.group",) + _LOOP_RECORDS) \
        == _strip(jreg.records)
    assert [r["attrs"]["infos"] for r in reg.records
            if r["name"] == "verify.done"] == [2]
    result, = [r for r in reg.records if r["name"] == "solver.result"]
    jresult, = [r for r in jreg.records if r["name"] == "solver.result"]
    assert result["attrs"]["iterations"] == int(jres.iterations) \
        == int(res.iterations)
    threshold = 1e-6 * float(np.linalg.norm(b))
    assert result["attrs"]["final_residual"] <= threshold
    assert jresult["attrs"]["final_residual"] <= threshold
    lir = exe._impl.lir
    groups = lambda stages: sum(len(cs.ir.groups) for cs in stages  # noqa
                                if cs.tag == "program")
    spans = [r for r in reg.records if r["name"] == "kernel.group"]
    assert len(spans) == groups(lir.setup) + \
        int(res.iterations) * groups(lir.body)
    # the port's loop spans hold them: setup stages under the solve,
    # body stages under their iteration
    assert {r["path"] for r in spans} == {
        "solver.solve/loop.stage/kernel.group",
        "solver.solve/loop.iter/loop.stage/kernel.group"}


def test_loop_trace_fires_once_per_build():
    lp = LoopProgram(specs.CG_LOOP, device=CPU, max_iters=20)
    ops = _t(_cg_ops())
    with obs.capture() as reg:
        lp.solve(**ops)
        lp.solve(**ops)
    traces = [r for r in reg.records if r["name"] == "loop.trace"]
    assert [t["attrs"]["trace"] for t in traces] == [1]
    assert lp.trace_count == 1
    assert len([r for r in reg.records
                if r["name"] == "solver.solve"]) == 2


def test_gmres_restarts_record_loop_inner_spans():
    """Each nested loop of a restart is one `loop.inner` span inside
    its solve (the reference takes them only when it runs eagerly)."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((N, N)) / np.sqrt(N)
         + 3.0 * np.eye(N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    lp = LoopProgram(specs.gmres_loop(8), device=CPU)
    with obs.capture() as reg:
        res = lp.solve(A=torch.from_numpy(a), b=torch.from_numpy(b),
                       x0=torch.zeros(N))
    inner = [r for r in reg.records if r["name"] == "loop.inner"]
    loops_per_restart = sum(1 for cs in lp.lir.body if cs.tag == "loop")
    assert len(inner) == loops_per_restart * int(res.iterations) > 0
    assert all(r["path"] == "solver.solve/loop.iter/loop.stage/loop.inner"
               for r in inner)


def test_recording_off_records_nothing_and_keeps_the_bits():
    """The default: a compile and a solve leave both registries empty,
    and the solve is bitwise the recorded one."""
    ops = _t({"A": _spd(), "b": np.ones(N, np.float32),
              "x0": np.zeros(N, np.float32)})
    exe = blas.compile(specs.CG_LOOP, max_iters=100, device=CPU)
    off = exe.run(**ops)
    assert obs.records() == [] and obs.counters() == {}
    assert jobs.records() == []
    with obs.capture():
        on = exe.run(**ops)
    assert torch.equal(on.x, off.x)
    assert int(on.iterations) == int(off.iterations)
    assert obs.records() == []


# ---------------------------------------------------------------------------
# Executable.profile: the drift report's model side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["gemv_chain", "axpydot", "cg_loop"])
@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
def test_profile_rows_equal_reference(case, mode, empty_tables):
    """`Executable.profile` joins the same groups with the same modeled
    flops, bytes and roofline times (the port's card rates against the
    reference's figures, so times are compared as bytes and flops), and
    measures every row; measured times are not compared."""
    if case == "cg_loop":
        raw, jraw = specs.CG_LOOP, jspecs.CG_LOOP
        shapes = {"A": (N, N), "b": N, "x0": N}
    elif case == "axpydot":
        raw, jraw = AXPYDOT_SPEC, J_AXPYDOT_SPEC
        shapes = {"v": N, "w": N, "u": N}
    else:
        raw = jraw = _gemv_chain("obs_profile_chain")
        shapes = {"A": (N, N), "p": N, "y0": N, "r": N}
    got = blas.compile(raw, mode=mode, device=CPU).profile(shapes, iters=2)
    want = jblas.compile(jraw, mode=mode, tiles="default").profile(
        shapes, iters=2)
    key = lambda r: (r.label, r.routines, r.anchor, r.calls,  # noqa: E731
                     r.modeled_flops, r.modeled_bytes)
    assert [key(r) for r in got.rows] == [key(r) for r in want.rows]
    assert (got.program, got.mode, got.kind, got.iters) == \
        (want.program, want.mode, want.kind, want.iters)
    assert all(r.measured_s is not None and r.measured_s > 0
               for r in got.rows)
    assert got.unmatched == ()


# ---------------------------------------------------------------------------
# Spans on the profiler's clock, without waiting: one call's span tree
# ---------------------------------------------------------------------------


def _axpydot_exe(n=64):
    exe = blas.compile(AXPYDOT_SPEC, device=CPU)
    w, v, u = torch.randn(3, n, generator=torch.Generator().manual_seed(3))
    return exe, {"neg_alpha": torch.tensor(-0.75), "w": w, "v": v, "u": u}


def test_span_ids_parents_and_clock():
    """Each span carries its id, its parent's id and its start and end
    on `time.time_ns()`; `t` and `dur_s` keep their meaning."""
    t0 = time.time_ns()
    with obs.capture() as reg:
        with obs.span("outer"):
            with obs.span_with("inner", {"k": 1}):
                pass
        first = reg.records
        again = reg.records
    t1 = time.time_ns()
    inner, outer = first
    assert again == first and inner is again[0]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert inner["id"] != outer["id"]
    assert t0 <= outer["start_ns"] <= inner["start_ns"] <= \
        inner["end_ns"] <= outer["end_ns"] <= t1
    for r in first:
        assert r["dur_s"] == (r["end_ns"] - r["start_ns"]) / 1e9
        assert r["t"] >= 0.0
    assert inner["attrs"] == {"k": 1} and inner["path"] == "outer/inner"


def test_no_wait_capture_never_blocks(monkeypatch):
    """Under `capture(wait=False)` no site of a program call waits for
    the device: `obs.block` is never called. The default registry
    waits, which the same calls show."""
    exe, inputs = _axpydot_exe()
    calls = []
    monkeypatch.setattr(obs, "block", lambda values: calls.append(values))
    with obs.capture():
        assert obs.waiting()
        exe.run(**inputs)
    assert calls                   # the waiting registry blocks
    calls.clear()

    def refuse(values):
        raise AssertionError("a site waited for the device")
    monkeypatch.setattr(obs, "block", refuse)
    with obs.capture(wait=False) as reg:
        assert obs.enabled() and not obs.waiting()
        for _ in range(3):
            exe.run(**inputs)
    names = [r["name"] for r in reg.records if r["kind"] == "span"]
    assert names.count("program.call") == 3
    assert names.count("kernel.group") == 3


def test_program_call_is_the_root_of_its_spans():
    """`Executable.run` opens `program.call`; the call's `kernel.group`
    spans point to it, and every parent id agrees with the path."""
    exe, inputs = _axpydot_exe()
    with obs.capture(wait=False) as reg:
        exe.run(**inputs)
        exe.run(**inputs)
    spans = [r for r in reg.records if r["kind"] == "span"]
    by_id = {r["id"]: r for r in spans}
    assert len(by_id) == len(spans)
    for r in spans:
        up = by_id.get(r["parent"])
        assert r["path"] == (r["name"] if up is None else
                             up["path"] + "/" + r["name"])
    calls = [r for r in spans if r["name"] == "program.call"]
    groups = [r for r in spans if r["name"] == "kernel.group"]
    assert len(calls) == len(groups) == 2
    assert all(r["parent"] is None for r in calls)
    for g in groups:
        call = by_id[g["parent"]]
        assert call["name"] == "program.call"
        assert g["path"] == "program.call/kernel.group"
        assert call["start_ns"] <= g["start_ns"] <= g["end_ns"] <= \
            call["end_ns"]
    assert groups[0]["parent"] != groups[1]["parent"]


def test_call_stamps_bracket_its_profiler_events():
    """Under a CPU-activity `torch.profiler`, each `aten::` event of the
    calls lies inside one `program.call` span's nanosecond stamps, and
    each call holds some: the spans share the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    exe, inputs = _axpydot_exe()
    exe.run(**inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture(wait=False) as reg:
            for _ in range(20):
                exe.run(**inputs)
    calls = sorted((r["start_ns"], r["end_ns"]) for r in reg.records
                   if r["name"] == "program.call")
    events = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert len(calls) == 20 and events
    held = [0] * len(calls)
    for a, b in events:
        at = [i for i, (lo, hi) in enumerate(calls) if lo <= a and b <= hi]
        assert len(at) == 1, (a, b)
        held[at[0]] += 1
    assert all(held)


def test_recording_off_takes_no_call_span():
    """Recording off: the new sites hand out the shared `NULL_SPAN`, and
    a call records nothing and waits for nothing."""
    assert obs.span_with("program.call") is obs.NULL_SPAN
    assert not obs.waiting()
    exe, inputs = _axpydot_exe()
    out = exe.run(**inputs)
    assert obs.records() == [] and obs.counters() == {}
    with obs.capture(wait=False):
        on = exe.run(**inputs)
    assert torch.equal(on.one(), out.one())
    assert obs.records() == []
