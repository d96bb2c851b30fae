"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration, whose `file` is
`configs/<name>.json`, and a traffic mix, `traffic/<name>.json`. A
configuration's `system` key names `systems/<system>.py`, a traffic
mix's `driver` key `drivers/<driver>.py`, and each metric has its
reader in `metrics/<metric name>.py`. Adding a cell, a configuration or
a metric adds files and entries; no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench: pathlib.Path = HERE) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str, bench: pathlib.Path = HERE):
    """`<bench>/<kind>/<name>.py` as a module (a metric's name has dots,
    so it is loaded from its path, not imported)."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    key = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metrics a cell reports: its `end_to_end` ones in an untraced
    run, its `per_layer` ones in a traced run. A metric with a
    `workloads` list belongs to those cells; one without it to every
    cell (a per-layer metric: every cell that reports what it moves)."""
    e2e = [m for m in manifest["end_to_end"] if _in(m, cell_name)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if _in(m, cell_name) and ("workloads" in m
                                      or m["moves"] in moved)]


def _in(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]
