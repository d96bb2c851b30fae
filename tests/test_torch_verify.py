"""Port parity for `repro_torch.verify`, the static analyzer, against
`repro.verify`, on the CPU. Mirrors tests/test_verify.py: one golden
broken spec per diagnostic code, clean passes over every shipped spec,
the raising and reporting API, and the CLI.

What must agree with the reference, exactly: for every golden spec but
RV401's, the set of (code, severity, path) the two analyzers report for
the same raw spec, and each report's counts. RV401 is the one pass that
differs: the reference prices a group's `window_size` windows against a
16 MiB TPU budget, the port what its kernels request per thread block
against the card's per-block shared memory (227 KiB on sm_90,
`REPRO_TORCH_SMEM_BUDGET` overrides it). The reference's golden
(`window_size: 4096` on a gemm) is clean in the port (ROADMAP Queue 3,
item 5) and runs; under a small budget RV401 fires on a gemv-anchored
group with the reference's path and severities.
"""
import copy
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from repro import verify as jverify
from repro_torch import blas, verify
from repro_torch.blas import functional
from repro_torch.core import lowering, routines as R, spec as spec_mod
from repro_torch.core.spec import SpecError
from repro_torch.kernels import common
from repro_torch.solvers import specs
from repro_torch.verify import VerifyError
from repro_torch.verify.__main__ import main as verify_cli

from _torch_caches import fresh_lowering_caches  # noqa: F401 (autouse)
from _torch_obs import isolated_obs_registries  # noqa: F401 (autouse)

CPU = "cpu"
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "broken_spec.json"


def _loop(**over):
    """Minimal valid loop spec (Richardson on A) to mutate. Its `x -> x`
    feedback edge trips the RV204 lint."""
    base = {
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
    base.update(over)
    return base


def _body(*stages):
    bad = _loop()
    bad["iterate"] = {**bad["iterate"],
                      "body": list(stages) + bad["iterate"]["body"]}
    return bad


def _stacked(*stages, slots=3):
    bad = _loop()
    bad["iterate"] = {
        **bad["iterate"],
        "state": {**bad["iterate"]["state"],
                  "S": {"kind": "stack", "slots": slots, "of": "scalar"}},
        "body": [{"let": {"one": "1"}}] + list(stages)
        + bad["iterate"]["body"],
    }
    return bad


def _rebind():
    bad = _loop()
    bad["iterate"] = {**bad["iterate"], "body": bad["iterate"]["body"] + [
        {"program": specs.RESIDUAL, "inputs": {"x": "x"},
         "outputs": {"r": "r_next", "rnorm": "rn2"}}]}
    return bad


def _reserved():
    bad = _loop()
    bad["operands"] = {**bad["operands"], "threshold": "scalar"}
    return bad


def _metric():
    bad = _loop()
    bad["iterate"] = {**bad["iterate"],
                      "while": {"metric": "bnorm", "init": "rnorm0",
                                "max_iters": 5}}
    return bad


def _unknown_input():
    bad = _loop()
    bad["iterate"] = {**bad["iterate"], "body": [
        {"program": specs.RESIDUAL, "inputs": {"nope": "x"},
         "outputs": {"r": "r_next", "rnorm": "rnorm"}}]}
    return bad


def _matrix_feedback():
    bad = copy.deepcopy(specs.BLOCK_CG_LOOP)
    bad["iterate"]["feedback"]["x"] = bad["iterate"]["while"]["metric"]
    return bad


# (golden id, spec, code, path, severity): tests/test_verify.py's goldens
GOLDENS = [
    ("rv100", lambda: {"routines": []}, "RV100", "routines", "error"),
    ("rv101", lambda: {"routines": [{"blas": "nope", "name": "n"}]},
     "RV101", "routines[0].blas", "error"),
    ("rv102", lambda: {"routines": [{"blas": "dot", "name": "d"},
                                    {"blas": "dot", "name": "d"}]},
     "RV102", "routines[1].name", "error"),
    ("rv103", lambda: {"routines": [{"blas": "dot", "name": "d",
                                     "connections": {"nope": ["d.x"]}}]},
     "RV103", "routines[0].connections.nope", "error"),
    ("rv104", lambda: {"routines": [
        {"blas": "scal", "name": "s", "connections": {"out": ["zz.x"]}},
        {"blas": "dot", "name": "d"}]},
     "RV104", "routines[0].connections.out", "error"),
    ("rv105", lambda: {"routines": [
        {"blas": "dot", "name": "d", "connections": {"out": ["s.x"]}},
        {"blas": "scal", "name": "s"}]},
     "RV105", "routines[0].connections.out", "error"),
    ("rv106", lambda: {"routines": [
        {"blas": "scal", "name": "sc",
         "connections": {"out": ["d.x", "d.x"]}},
        {"blas": "dot", "name": "d"}]},
     "RV106", "routines[0].connections.out", "error"),
    ("rv107", lambda: {"routines": [
        {"blas": "copy", "name": "c1", "connections": {"out": ["c2.x"]}},
        {"blas": "copy", "name": "c2", "connections": {"out": ["c1.x"]}}]},
     "RV107", "routines", "error"),
    ("rv108", lambda: {"routines": [
        {"blas": "axpy", "name": "a", "scalars": {"alpha": {"input": "v"}},
         "inputs": {"x": "v"}}]},
     "RV108", "routines[0]", "error"),
    ("rv109", lambda: {"routines": [
        {"blas": "scal", "name": "s1", "outputs": {"out": "y"}},
        {"blas": "scal", "name": "s2", "outputs": {"out": "y"}}]},
     "RV109", "routines[1].outputs.out", "error"),
    ("rv110", lambda: {"dtype": "bfloat16",
                       "routines": [{"blas": "dot", "name": "d"}]},
     "RV110", "routines[0]", "warning"),
    ("rv111", lambda: {"dtype": "float64",
                       "routines": [{"blas": "dot", "name": "d"}]},
     "RV111", "dtype", "error"),
    ("rv112", lambda: {"vector_width": 100,
                       "routines": [{"blas": "dot", "name": "d"}]},
     "RV112", "vector_width", "error"),
    ("rv112_override", lambda: {"routines": [
        {"blas": "dot", "name": "d", "vector_width": 100}]},
     "RV112", "routines[0].vector_width", "error"),
    ("rv201", lambda: _body({"let": {"z": "nosuch * 2"}}),
     "RV201", "iterate.body[0].z", "error"),
    ("rv202", _rebind, "RV202", "iterate.body[1]", "error"),
    ("rv203", lambda: _body({"let": {"unused": "rnorm0 * 2"}}),
     "RV203", "iterate.body[0].unused", "warning"),
    ("rv204", _loop, "RV204", "iterate.feedback.x", "warning"),
    ("rv205", lambda: _body({"cond": {"if": "1 <= 2",
                                      "then": [{"let": {"z": "1"}}],
                                      "else": [{"let": {"z": "2"}}]}}),
     "RV205", "iterate.body[0].cond.if", "warning"),
    ("rv206", lambda: _stacked({"store": {"into": "S", "slot": "5",
                                          "value": "one"}}),
     "RV206", "iterate.body[1].store.slot", "error"),
    ("rv206_counter", lambda: _stacked({"iterate": {
        "counter": "j", "state": {"h": {"init": "rnorm0"}},
        "body": [{"read": {"name": "sj", "from": "S", "slot": "j"}},
                 {"let": {"h2": "h * sj"}}],
        "feedback": {"h": "h2"}, "while": {"count": 5}}}),
     "RV206", "iterate.body[1].iterate.body[0].read.slot", "warning"),
    ("rv207", _reserved, "RV207", "iterate.state", "error"),
    ("rv208", lambda: _stacked({"store": {"into": "S", "slot": "0",
                                          "value": "r"}}),
     "RV208", "iterate.body[1].store.value", "error"),
    ("rv209", _metric, "RV209", "iterate.while.metric", "error"),
    ("rv210", lambda: _stacked({"cond": {
        "if": "rnorm0 <= 1",
        "then": [{"store": {"into": "S", "slot": "0", "value": "one"}},
                 {"let": {"z": "1"}}],
        "else": [{"let": {"z": "2"}}]}}),
     "RV210", "iterate.body[1].cond.then[0].store", "error"),
    ("rv211", _unknown_input, "RV211", "iterate.body[0]", "error"),
    ("rv301", lambda: _body({"let": {"z": "rnorm0 / (2 - 2)"}}),
     "RV301", "iterate.body[0].z", "error"),
    ("rv302", lambda: _body({"let": {"z": "sqrt(0 - 1)"}}),
     "RV302", "iterate.body[0].z", "error"),
    ("rv302_unprovable", lambda: _body({"let": {"z": "sqrt(rnorm0 - 1)"}}),
     "RV302", "iterate.body[0].z", "warning"),
    ("rv303", lambda: _body({"let": {"z": "rnorm0 / bnorm"}}),
     "RV303", "iterate.body[0].z", "info"),
    ("rv402", lambda: {"window_size": 200,
                       "routines": [{"blas": "dot", "name": "d"}]},
     "RV402", "routines[0].window_size", "warning"),
    ("rv403", lambda: _stacked(
        {"store": {"into": "S", "slot": "0", "value": "one"}},
        {"store": {"into": "S", "slot": "0", "value": "one"}}),
     "RV403", "iterate.body[2].store", "warning"),
    ("rv504", _matrix_feedback, "RV504", "iterate.feedback.x", "error"),
]


def _triples(report):
    return {(d.code, d.severity, d.path) for d in report.diagnostics}


@pytest.mark.parametrize("case", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_golden_broken_specs_match_the_reference(case):
    _, make, code, path, severity = case
    raw = make()
    got = verify.analyze(copy.deepcopy(raw))
    want = jverify.analyze(copy.deepcopy(raw))
    assert (code, severity, path) in _triples(got)
    assert _triples(got) == _triples(want)
    assert got.to_dict()["counts"] == want.to_dict()["counts"]
    assert got.program == want.program and got.kind == want.kind


def test_catalog_has_the_reference_codes():
    assert set(verify.CATALOG) == set(jverify.CATALOG)
    differ = {c for c in verify.CATALOG
              if verify.CATALOG[c] != jverify.CATALOG[c]}
    assert differ == {"RV401"}
    assert "shared-memory" in verify.CATALOG["RV401"]


# ---------------------------------------------------------------------------
# Clean passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["CG_LOOP", "JACOBI_LOOP",
                                  "BICGSTAB_LOOP", "GMRES_LOOP",
                                  "BLOCK_CG_LOOP"])
def test_shipped_loop_specs_verify_clean_in_both(name):
    raw = getattr(specs, name)
    report = verify.analyze(raw)
    assert report.errors == () and report.warnings == (), report.format()
    assert _triples(report) == _triples(jverify.analyze(raw))


@pytest.mark.parametrize("mode", ["dataflow", "nodataflow"])
def test_all_routine_specs_verify_clean_in_both(mode):
    for name in R.names():
        raw = functional.routine_spec(name)
        report = verify.analyze(raw, mode=mode)
        assert report.ok and not report.warnings, report.format()
        assert jverify.analyze(raw, mode=mode).ok


# ---------------------------------------------------------------------------
# RV401: the known difference, and the pass under a small budget
# ---------------------------------------------------------------------------


def test_rv401_window_size_golden_is_clean_in_the_port_and_runs():
    """The reference's RV401 golden (4096² windows on a gemm, ~256 MiB
    against 16 MiB of VMEM) prices no kernel of the port's: gemm's block
    asks the same shared memory whatever the window size. ROADMAP Queue
    3, item 5. The program compiles and runs at a small n."""
    raw = {"window_size": 4096, "routines": [{"blas": "gemm", "name": "g"}]}
    assert any(d.code == "RV401" for d in jverify.analyze(raw).errors)
    report = verify.analyze(raw)
    assert not report.by_code("RV401") and report.ok
    exe = blas.compile(raw, device=CPU)
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal((8, 8)).astype(
        np.float32)) for _ in range(3))
    out = exe.run(**{"g.A": a, "g.B": b, "g.C": c, "g.alpha": 1.5,
                     "g.beta": 0.5}).one()
    want = 1.5 * a.double() @ b.double() + 0.5 * c.double()
    torch.testing.assert_close(out, want.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget_kib,severity", [(4, "warning"),
                                                 (2, "error")])
def test_rv401_fires_on_a_gemv_anchored_group_under_a_small_budget(
        monkeypatch, budget_kib, severity):
    """The gemv anchor's block (2.5 KiB under the default plan, its
    estimate) against a budget set in the environment: over half of it
    a warning, over all of it an error, at the group's first routine as
    in the reference."""
    monkeypatch.setenv(common.ENV_SMEM_BUDGET, str(budget_kib * 1024))
    report = verify.analyze(specs.CG_MATVEC)
    hits = report.by_code("RV401")
    assert [(d.severity, d.path) for d in hits] == [(severity,
                                                     "routines[0]")]
    assert "gemv+dot" in hits[0].message
    if severity == "error":
        with pytest.raises(VerifyError):
            lowering.compile_cached(specs.CG_MATVEC, device=CPU)


def test_rv401_default_budget_is_the_sm90_figure(monkeypatch):
    monkeypatch.delenv(common.ENV_SMEM_BUDGET, raising=False)
    if not torch.cuda.is_available():
        assert common.smem_budget() == 227 * 1024
    monkeypatch.setenv(common.ENV_SMEM_BUDGET, "12345")
    assert common.smem_budget() == 12345


# ---------------------------------------------------------------------------
# The API: the raising gate, multi-error reports, verify=False
# ---------------------------------------------------------------------------


def test_verify_error_carries_all_diagnostics():
    bad = _body({"let": {"z": "nosuch * 2"}},
                {"let": {"w": "alsomissing + 1"}})
    with pytest.raises(VerifyError) as ei:
        lowering.lower_loop(bad, device=CPU)
    report = ei.value.report
    assert len(report.by_code("RV201")) == 2
    assert "not defined" in str(ei.value)
    assert ei.value.code == "RV201"


def test_verify_error_is_a_spec_error():
    assert issubclass(VerifyError, SpecError)
    with pytest.raises(SpecError):
        lowering.lower({"routines": []}, device=CPU)


def test_verify_error_message_matches_the_reference():
    from repro.core import lowering as jlowering
    bad = _body({"let": {"z": "nosuch * 2"}})
    with pytest.raises(Exception) as want:
        jlowering.lower_loop(copy.deepcopy(bad))
    with pytest.raises(VerifyError) as got:
        lowering.lower_loop(copy.deepcopy(bad), device=CPU)
    assert str(got.value) == str(want.value)
    assert (got.value.code, got.value.path) == (want.value.code,
                                                want.value.path)


def test_malformed_spec_fails_before_any_kernel_is_built(tmp_path,
                                                         monkeypatch):
    """The analyzer probes stage programs (parse, graph, infer): no frame
    of `repro_torch/kernels` or `core/codegen.py` is on the stack when
    it raises, and nothing is written to the kernel cache directory."""
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    bad = _body({"let": {"z": "nosuch * 2"}})
    with pytest.raises(VerifyError) as ei:
        lowering.lower_loop(bad, device=CPU)
    paths = [str(f.path) for f in ei.traceback]
    assert not any("repro_torch/kernels" in p or p.endswith(
        os.path.join("core", "codegen.py")) for p in paths), paths
    assert not (tmp_path / "build").exists()
    report = verify.analyze(specs.GMRES_LOOP)
    assert report.ok and not (tmp_path / "build").exists()


def test_verify_false_raises_at_the_first_site():
    bad = _body({"let": {"z": "nosuch * 2"}})
    with pytest.raises(SpecError) as ei:
        lowering.lower_loop(bad, device=CPU, verify=False)
    assert not isinstance(ei.value, VerifyError)
    assert "nosuch" in str(ei.value)
    bad = {"routines": [{"blas": "axpy", "name": "a",
                         "scalars": {"alpha": {"input": "v"}},
                         "inputs": {"x": "v"}}]}
    with pytest.raises(SpecError, match="conflicting kinds") as ei:
        lowering.lower(bad, upto="infer", verify=False)
    assert not isinstance(ei.value, VerifyError)


def test_executable_verify_and_the_compile_gate():
    exe = blas.compile({"routines": [{"blas": "dot", "name": "d"}]},
                       device=CPU)
    report = exe.verify()
    assert report.ok and report.kind == "dataflow"
    loop = blas.compile(specs.CG_LOOP, device=CPU)
    assert loop.verify().by_code("RV303")
    with pytest.raises(VerifyError):
        blas.compile({"routines": [{"blas": "dot", "name": "d",
                                    "connections": {"out": ["d.x"]}}]},
                     device=CPU)


def test_solver_driver_verify_flag_takes_effect():
    from repro_torch.solvers import LoopProgram
    bad = _body({"let": {"z": "nosuch * 2"}})
    with pytest.raises(VerifyError):
        LoopProgram(bad, device=CPU)
    with pytest.raises(SpecError) as ei:
        LoopProgram(bad, device=CPU, verify=False)
    assert not isinstance(ei.value, VerifyError)


def test_report_json_round_trip():
    report = verify.analyze(_loop())
    doc = json.loads(report.to_json())
    assert doc == json.loads(jverify.analyze(_loop()).to_json())
    assert doc["program"] == "mini" and doc["kind"] == "loop"
    assert "RV204" in {d["code"] for d in doc["diagnostics"]}


def test_structured_fields_on_spec_error():
    with pytest.raises(SpecError) as ei:
        spec_mod.parse({"routines": [{"blas": "nope", "name": "n"}]})
    assert ei.value.code == "RV101"
    assert ei.value.path == "routines[0].blas"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_all_shipped_clean(capsys):
    assert verify_cli(["--all-shipped", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and len(doc["specs"]) >= 21


def test_cli_broken_fixture_matches_the_reference(capsys):
    from repro.verify.__main__ import main as jmain
    assert verify_cli([str(FIXTURE), "--json"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert jmain([str(FIXTURE), "--json"]) == 1
    want = json.loads(capsys.readouterr().out)
    assert got == want
    codes = {d["code"] for s in got["specs"] for d in s["diagnostics"]}
    assert {"RV201", "RV301", "RV203", "RV204"} <= codes
