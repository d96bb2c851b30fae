"""The manifest and the harness's shape: names, files found by name,
the result line, and what the harness may import."""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

from portbench import core, manifest as mf

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
TINY = {
    "axpydot-stream": ({"n": 4096}, {"alpha_pool": 8, "warm_calls": 2,
                                     "probe_rounds": 2, "probe_calls": 3}),
}


def problems(manifest: dict) -> list:
    """Names and units outside the characters they may hold, and
    duplicates: a list of messages, empty when the manifest is sound."""
    out = []
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            names.append((group if group in ("configs", "workloads")
                          else "metrics", e["name"]))
            if not mf.NAME.fullmatch(e["name"]):
                out.append(f"{group}: bad name {e['name']!r}")
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{group}: bad unit {e['unit']!r}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not mf.NAME.fullmatch(w[key]):
                out.append(f"workload {w['name']}: bad {key} {w[key]!r}")
    for c in manifest["configs"]:
        out += [f"config {c['name']}: bad reduced key {k!r}"
                for k in c["reduced"] if not mf.NAME.fullmatch(k)]
    for kind in ("configs", "workloads", "metrics"):
        seen = [n for k, n in names if k == kind]
        out += [f"duplicate name {n!r}" for n in set(seen)
                if seen.count(n) > 1]
    return out


def result_problems(line: dict) -> Optional[str]:
    """Why a result line breaks the contract's shape, or None."""
    keys = [k for k in line if k not in ("breakdown", "checks")]
    if sorted(keys) != sorted(RESULT_KEYS):
        return f"keys {sorted(line)}"
    for name, m in line["metrics"].items():
        if set(m) != {"value", "unit"}:
            return f"metric {name}: keys {sorted(m)}"
    return None


def tiny_run(cell, trace, *, root=ROOT, seconds=0.15, seed=2 ** 31 + 11):
    cfg, traffic = TINY[cell]
    run = core.prepare(cell, seed, seconds, trace, "cpu", root=root,
                       config_overrides=cfg, traffic_overrides=traffic)
    return core.execute(run, time.perf_counter())


def test_manifest_names_units_and_shape():
    m = mf.load(ROOT)
    assert set(m) == KEYS
    assert problems(m) == []
    assert m["command"][1:] == ["portbench/run.py"]
    assert m["paths"] == ["portbench"]
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/configs/")
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"] + m["per_layer"]:
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()
    for p in m["per_layer"]:
        assert p["moves"] in e2e
    for w in m["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        reported = mf.metrics_of(m, w["name"], False)
        names = {e["name"] for e in reported}
        assert "setup_s" in names and len(names) >= 2
        layer = mf.metrics_of(m, w["name"], True)
        assert layer
        assert {p["moves"] for p in layer} <= names


def test_problems_catch_bad_names():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"][0]["name"] = "bad name"
    m["end_to_end"][0]["unit"] = "tokens per second"
    m["per_layer"].append(dict(m["per_layer"][0]))
    found = problems(m)
    assert any("bad name" in p for p in found)
    assert any("bad unit" in p for p in found)
    assert any("duplicate" in p for p in found)


def test_result_line_keys(store):
    for cell in TINY:
        for trace in (0, 1):
            line = tiny_run(cell, trace)
            assert result_problems(line) is None
            assert list(line)[-1] == "checks"
            assert set(line) - {"breakdown", "checks"} == \
                set(RESULT_KEYS)
            assert line["correct"] is True, line["checks"]
            assert line["attempted"] > 0 and line["failed"] == 0
            json.dumps(line)


def test_a_new_cell_is_found_by_name(tmp_path, store):
    """A configuration, a traffic mix and a metric added as files, and
    their entries added to the manifest, run without any file that is
    there being edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((BENCH / "configs" / "axpydot-2p26.json").read_text())
    cfg.update(name="axpydot-small", n=2048)
    (root / "portbench/configs/axpydot-small.json").write_text(
        json.dumps(cfg))
    (root / "portbench/traffic/pair.json").write_text(json.dumps(
        {"driver": "stream", "alpha_pool": 2, "alpha_low": 0.25,
         "alpha_high": 0.75, "warm_calls": 1, "probe_rounds": 1,
         "probe_calls": 2}))
    (root / "portbench/metrics/calls_seen.py").write_text(
        "def read(run):\n    return run.windows['traced'].calls\n")
    m["configs"].append({"name": "axpydot-small", "source": "x",
                         "file": "portbench/configs/axpydot-small.json",
                         "reduced": ["n"], "why": "x"})
    m["workloads"].append({"name": "pair-cell", "config": "axpydot-small",
                           "traffic": "pair", "chips": 1, "why": "x"})
    m["end_to_end"][0]["workloads"].append("pair-cell")
    m["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "public API and runtime",
                           "moves": "calls_per_s",
                           "workloads": ["pair-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert problems(m) == []
    for trace in (0, 1):
        run = core.prepare("pair-cell", 5, 0.1, trace, "cpu", root=root)
        line = core.execute(run, time.perf_counter())
        assert line["correct"] is True
        want = {"calls_seen"} if trace else \
            {"calls_per_s", "setup_s"}
        assert want <= set(line["metrics"])
    for p, data in before.items():
        assert p.read_bytes() == data


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args
                        if isinstance(a, ast.Constant))


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in core.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for stem in ("reference", "work", "tracing"):
        tops = {n.split(".")[0] for n in _imports(BENCH / f"{stem}.py")}
        assert tops <= set(sys.stdlib_module_names) | {"torch"}, (stem, tops)


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "axpydot-stream", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_the_command_refuses_without_the_port(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "axpydot-stream", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
