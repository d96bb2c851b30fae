"""Port parity for the distributed layer (`repro_torch.core.distributed`,
`core.placement`, `launch.mesh` and the sharded MoE variants of
`models/moe.py`) against `repro.core.distributed` and `repro.models.moe`.

An 8-rank gloo world on a (4, 2) ("data", "model") mesh runs every
function of tests/_distributed_check.py at its sizes, twice, each rank
in a subprocess (tests/_torch_distributed_check.py); the reference runs
in a JAX subprocess with 8 forced host devices on the same npz inputs.
Every rank is passed the global operands, takes its block and writes
the gathered global result.

What must agree: each result with the reference's within
tests/_distributed_check.py's tolerances; every result bitwise across
the 8 ranks and across the two runs (the port's psum is an all_gather
and a sum in rank order); nrm2 through `distribute_program` with
numpy's norm, where the reference's gives the sum of the shards' norms
(its psum of every scalar output); a coldot and colaxpy program with
the same program on one device; each rank's placed blocks with the
slices its mesh coordinate names. The refusals (iamax, a level-2
routine, a reduction read inside the program, an unknown pgemm
strategy, conflicting placement hints) raise before any collective and
run in this process.
"""
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import Program, lowering, placement
from repro_torch.core import distributed as D
from repro_torch.core.runtime import GEMV_SPEC
from repro_torch.solvers import specs

HERE = pathlib.Path(__file__).resolve().parent
CHECK = HERE / "_torch_distributed_check.py"
SRC = str(HERE.parent / "src")
WORLD, RUNS, TIMEOUT = 8, ("a", "b"), 240

sys.path.insert(0, str(HERE))
import _torch_distributed_check as C  # noqa: E402

# name -> (rtol, atol), as tests/_distributed_check.py holds each
TOLERANCES = {
    "paxpy": (1e-5, 1e-5), "pdot": (1e-4, 1e-2), "paxpydot": (1e-4, 1e-2),
    "pgemv": (1e-4, 1e-3), "pgemm_row_col": (1e-4, 1e-3),
    "pgemm_contract": (1e-4, 1e-3), "program_axpydot": (1e-4, 1e-2),
    "moe_tp": (2e-4, 2e-4), "moe_ep": (2e-4, 2e-4),
}
RESULTS = sorted(TOLERANCES) + ["program_nrm2", "program_coldot",
                                "program_colaxpy"]


def _env(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               REPRO_TORCH_CACHE_DIR=str(tmp / "cache"))
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(tmp, args, log):
    with open(tmp / log, "w") as out:      # the child keeps its own copy
        return subprocess.Popen([sys.executable, str(CHECK), *args],
                                env=_env(tmp), stdout=out,
                                stderr=subprocess.STDOUT)


def _wait(procs, tmp, logs, timeout):
    """Wait for every process; on the first failure or at the deadline
    kill the rest (a rank whose peer died waits in its collective)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(log, p.returncode) for p, log in zip(procs, logs)
           if p.returncode != 0]
    assert not bad, "\n".join(f"{log} rc={rc}:\n{(tmp / log).read_text()}"
                              for log, rc in bad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    subprocess.run([sys.executable, str(CHECK), "inputs", str(tmp)],
                   env=_env(tmp), check=True, timeout=60)
    ref = _start(tmp, ["jax", str(tmp)], "jax.log")
    try:
        for tag in RUNS:
            logs = [f"{tag}_{r}.log" for r in range(WORLD)]
            _wait([_start(tmp, ["rank", str(tmp), str(r), str(WORLD), tag],
                          log) for r, log in enumerate(logs)],
                  tmp, logs, TIMEOUT)
    finally:
        _wait([ref], tmp, ["jax.log"], TIMEOUT)
    return {"inputs": dict(np.load(tmp / "inputs.npz")),
            "jax": dict(np.load(tmp / "jax.npz")),
            **{tag: [dict(np.load(tmp / f"{tag}_{r}.npz"))
                     for r in range(WORLD)] for tag in RUNS}}


@pytest.mark.parametrize("name", sorted(TOLERANCES))
def test_matches_reference(runs, name):
    got, want = runs["a"][0][name], runs["jax"][name]
    assert got.shape == want.shape and got.dtype == np.float32
    rtol, atol = TOLERANCES[name]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", RESULTS)
def test_bitwise_across_ranks_and_runs(runs, name):
    first = runs["a"][0][name]
    for tag in RUNS:
        for r in range(WORLD):
            assert np.array_equal(runs[tag][r][name], first), (tag, r)


def test_nrm2_combines_the_norms_where_the_reference_sums_them(runs):
    """The reference psums every scalar output: for nrm2 over 4 data
    shards it returns the sum of the shards' norms (181.15 on this
    vector); the port returns the norm, as one device does."""
    x = runs["inputs"]["nrm2_x"]
    got, want = float(runs["a"][0]["program_nrm2"]), np.linalg.norm(x)
    single = Program.from_spec(specs.NRM2, device="cpu")(
        x=torch.from_numpy(x))["norm"]
    assert got == pytest.approx(float(single), rel=1e-6)
    assert got == pytest.approx(want, rel=1e-6)
    shards = sum(np.linalg.norm(s) for s in np.split(x, 4))
    assert float(runs["jax"]["program_nrm2"]) == pytest.approx(shards,
                                                               rel=1e-5)
    assert float(runs["jax"]["program_nrm2"]) == pytest.approx(181.152,
                                                               abs=1e-3)


def test_column_programs_combine_coldot_and_keep_colaxpy_a_whole(runs):
    """coldot's per-column sums add over the row shards; colaxpy's a has
    one entry per column, so every shard takes it whole. Held to the
    same program on one device (the reference shards a with the rows)."""
    ins = {k: torch.from_numpy(runs["inputs"][f"col_{k.lower()}"])
           for k in ("X", "Y", "a")}
    want = Program.from_spec(C.COLUMN_SPEC, device="cpu")(**ins)
    np.testing.assert_allclose(runs["a"][0]["program_coldot"],
                               want["rz"].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(runs["a"][0]["program_colaxpy"],
                                  want["Z"].numpy())


def test_each_rank_takes_the_blocks_its_coordinate_names(runs):
    ins = runs["inputs"]
    coords = set()
    for res in runs["a"]:
        data, model = (int(c) for c in res["coordinate"])
        coords.add((data, model))
        x_rows = slice(data * 2048, (data + 1) * 2048)
        np.testing.assert_array_equal(res["placed_px"], ins["x"][x_rows])
        # "pod" is no dimension of this mesh: y goes whole, as v (no hint)
        np.testing.assert_array_equal(res["placed_py"], ins["y"])
        np.testing.assert_array_equal(res["placed_pv"], ins["gemv_x"])
        np.testing.assert_array_equal(
            res["placed_pa"], ins["gemv_a"][data * 64:(data + 1) * 64,
                                            model * 96:(model + 1) * 96])
    assert coords == {(d, m) for d in range(4) for m in range(2)}


def test_make_host_mesh_falls_back_to_the_world(runs):
    for res in runs["a"]:
        assert res["world_mesh_shape"].tolist() == [4, 2]
        assert res["fallback_shape"].tolist() == [WORLD, 1]


def _iamax_spec():
    return {"name": "iamax_program", "routines": [
        {"blas": "iamax", "name": "im", "inputs": {"x": "x"},
         "outputs": {"out": "index"}}]}


@pytest.mark.parametrize("raw,match", [
    (_iamax_spec(), "output 'index' comes from im \\(iamax\\)"),
    (GEMV_SPEC, "level-1 programs only"),
    ({"name": "coldot_read", "routines": [
        {"blas": "coldot", "name": "cd", "inputs": {"x": "X", "y": "Y"},
         "connections": {"out": "ca.a"}},
        {"blas": "colaxpy", "name": "ca", "inputs": {"x": "X2", "y": "Y2"},
         "outputs": {"out": "Z"}}]}, "cd \\(coldot\\) feeds another"),
])
def test_distribute_program_refuses_what_shards_cannot_combine(raw, match):
    prog = Program.from_spec(raw, device="cpu")
    with pytest.raises(ValueError, match=match):
        D.distribute_program(prog, mesh=None)


def test_pgemm_refuses_an_unknown_strategy():
    a = torch.ones(4, 4)
    with pytest.raises(ValueError, match="unknown strategy 'diagonal'"):
        D.pgemm(None, a, a, strategy="diagonal")


_MESH = types.SimpleNamespace(mesh_dim_names=("data", "model"))


def _hinted(first, second):
    """Two routines reading the public input x, hinted apart."""
    return {"name": "hinted", "routines": [
        {"blas": "axpy", "name": "a0", "scalars": {"alpha": 1.0},
         "inputs": {"x": "x", "y": "y"}, "outputs": {"out": "o0"},
         "placement": {"x": first}},
        {"blas": "scal", "name": "s0", "scalars": {"alpha": 2.0},
         "inputs": {"x": "x"}, "outputs": {"out": "o1"},
         "placement": {"x": second}}]}


def test_placement_shardings_conflicts_on_the_mesh():
    """Two hints on one input conflict where they differ on this mesh:
    ("data",) against ("model",), and ("data",) against ("pod",), whose
    name is not a dimension here; two names that are both absent
    agree."""
    for first, second in ((["data"], ["model"]), (["data"], ["pod"])):
        graph = lowering.lower(_hinted(first, second), upto="infer").graph
        with pytest.raises(ValueError, match="conflicting placement"):
            placement.placement_shardings(graph, _MESH)
    graph = lowering.lower(_hinted(["pod"], ["expert"]), upto="infer").graph
    assert placement.placement_shardings(graph, _MESH) == {"x": (None,)}


def test_placement_shardings_read_the_lowered_hints():
    prog = Program.from_spec(C.PLACED_SPEC, device="cpu")
    assert prog.ir.placements == {"px": ("data",), "py": ("pod",),
                                  "pa": ("data", "model")}
    assert placement.placement_shardings(prog, _MESH) == \
        placement.placement_shardings(prog.ir, _MESH) == \
        {"px": ("data",), "py": (None,), "pa": ("data", "model")}
