"""The port stands alone: importing repro_torch and every one of its
submodules loads neither jax, nor any module of the reference package
`repro`, nor triton (which is imported only inside the functions that
launch a kernel), and starts no process: the CUDA sources are compiled
by `kernels/cuda.py` at first use on a card, never at import. The
command-line modules (`guard.__main__`, `obs.__main__`,
`verify.__main__`, `tune.__main__`) import with no side effect: they
print nothing, run no drill, tune nothing and record nothing; no module
(`launch.mesh` and `core.distributed` among them) starts a process
group."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, subprocess, sys

def no_process(*args, **kwargs):
    raise AssertionError(f"process started at import: {args}")

subprocess.Popen = subprocess.run = no_process
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 98, names
assert {"repro_torch.blas", "repro_torch.blas.builder",
        "repro_torch.blas.executable", "repro_torch.blas.functional",
        "repro_torch.blas.solvers", "repro_torch.blas.__main__",
        "repro_torch.solvers.iterative",
        "repro_torch.guard.status", "repro_torch.kernels.gemm",
        "repro_torch.kernels.ger", "repro_torch.kernels.tiled",
        "repro_torch.kernels.transpose", "repro_torch.solvers.driver",
        "repro_torch.solvers.specs", "repro_torch.kernels.attention",
        "repro_torch.kernels.decode_attention", "repro_torch.configs.base",
        "repro_torch.configs.registry", "repro_torch.configs.llama3_8b",
        "repro_torch.models.layers", "repro_torch.models.attention",
        "repro_torch.models.model", "repro_torch.models.convert",
        "repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.models.sharding", "repro_torch.models.partition",
        "repro_torch.core.distributed",
        "repro_torch.core.placement", "repro_torch.launch.mesh",
        "repro_torch.serve.engine", "repro_torch.launch.serve",
        "repro_torch.obs", "repro_torch.obs.core", "repro_torch.obs.report",
        "repro_torch.obs.__main__", "repro_torch.ft",
        "repro_torch.ft.watchdog", "repro_torch.tune",
        "repro_torch.tune.config", "repro_torch.tune.store",
        "repro_torch.guard.chaos", "repro_torch.guard.escalate",
        "repro_torch.guard.__main__", "repro_torch.verify",
        "repro_torch.verify.diagnostics", "repro_torch.verify.intervals",
        "repro_torch.verify.passes", "repro_torch.verify.engine",
        "repro_torch.verify.__main__", "repro_torch.tune.autotuner",
        "repro_torch.tune.__main__", "repro_torch.optim",
        "repro_torch.optim.adamw", "repro_torch.optim.compress",
        "repro_torch.data", "repro_torch.data.pipeline",
        "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
        "repro_torch.train", "repro_torch.train.step",
        "repro_torch.launch.train", "repro_torch.launch.roofline",
        "repro_torch.launch.cost", "repro_torch.launch.specs",
        "repro_torch.launch.dryrun"} <= set(names), names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
import torch.distributed as dist
assert not dist.is_initialized()
from repro_torch import obs
assert not obs.enabled() and obs.records() == [] and obs.counters() == {}
print(len(names))
"""


def test_port_imports_no_jax_repro_or_triton():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_TORCH_OBS_JSONL", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 98


ROOT = SRC.parent
_SCRIPTS = ["chip_smoke.py", "tools/sweep_gemv.py", "tools/time_decode.py",
            "tools/time_gemv.py", "tools/time_mha.py",
            "tools/time_obs_off.py", "tools/trace_programs.py"]


@pytest.mark.parametrize("script", _SCRIPTS)
def test_card_scripts_import_no_jax_or_repro(script):
    """chip_smoke.py and the port's timing tools run on the card host:
    no import statement of theirs, at any depth, names jax or the
    reference package `repro` (repro_torch only)."""
    tree = ast.parse((ROOT / script).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)
