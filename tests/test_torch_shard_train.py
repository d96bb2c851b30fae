"""The port's sharded training (`repro_torch.models.sharding`,
`models.partition`, `train.make_train_step(grad_specs=)`) against the
reference's GSPMD train step, in an 8-rank gloo world.

One world launch (tests/_torch_shard_check.py, a process per rank, a
file store) runs every case of its CASES twice, and two JAX
subprocesses on 8 forced host devices each run half of them through the
reference's jitted `make_train_step` under `jax.set_mesh`, the state
`device_put` onto its `param_specs`. Cases: reduced llama3-8b,
mixtral-8x22b (EP), deepseek-moe-16b, minicpm3-4b (MLA) and hymba-1.5b
in float32 on ("data" 4, "model" 2) in "2d"; llama3-8b and mixtral-8x22b
there in "fsdp"; llama3-8b on ("pod" 2, "data" 2, "model" 2); and
deepseek-moe-16b with 6 experts on ("data" 2, "model" 4), the TP
variant. Every segment has 2 layers; two steps from the same state.

What must agree:
* the losses with the reference's within 1e-6 relative (seen: <= 1.6e-7);
* the gathered parameters and both moments with the reference's, each
  tensor within 1e-5 of its largest element (seen: <= 1.5e-6), tighter
  than rtol 2e-4, atol 2e-5 for every tensor here;
* the dense configs also with the one-process port step on the whole
  batch, the same bound;
* every rank's stored block with the slice of the whole state its spec
  and mesh coordinate name;
* losses, blocks and the whole state bitwise across the 8 ranks and
  across two runs;
* the bytes each rank's gathers and gradient sums received in a step
  with `train.step_traffic`'s reckoning (so the MoE variants' expert
  weights are gathered over "data" only: each "model" rank holds its
  part).

The MoE configs are held to the reference's sharded step only: their
dispatch is per batch block (capacity per block), which drops other
pairs than one process over the whole batch.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as TS
from repro_torch.train import step_traffic

HERE = pathlib.Path(__file__).resolve().parent
CHECK = HERE / "_torch_shard_check.py"
SRC = str(HERE.parent / "src")
WORLD, TIMEOUT = 8, 300

sys.path.insert(0, str(HERE))
import _torch_shard_check as C  # noqa: E402

CASES = {c[0]: c for c in C.CASES}
DENSE = [c for c, (_, arch, *_rest) in CASES.items() if arch in C.DENSE]
PARTS = ("params", "m", "v")
LOSS_REL, STATE_REL = 1e-6, 1e-5


def _env(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
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
    tmp = tmp_path_factory.mktemp("shard")
    jlogs = [f"jax_{i}.log" for i in range(C.JAX_PARTS)]
    refs = [_start(tmp, ["jax", str(tmp), str(i)], log)
            for i, log in enumerate(jlogs)]
    try:
        logs = [f"rank_{r}.log" for r in range(WORLD)]
        _wait([_start(tmp, ["rank", str(tmp), str(r), str(WORLD)], log)
               for r, log in enumerate(logs)], tmp, logs, TIMEOUT)
    finally:
        _wait(refs, tmp, jlogs, TIMEOUT)
    jax = {}
    for i in range(C.JAX_PARTS):
        jax.update(np.load(tmp / f"jax_{i}.npz"))
    return {"jax": jax, "ranks": [dict(np.load(tmp / f"rank_{r}.npz"))
                                  for r in range(WORLD)]}


def _names(runs, case):
    return sorted(k[len(f"{case}/params/"):] for k in runs["jax"]
                  if k.startswith(f"{case}/params/"))


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STATE_REL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_reference(runs, case):
    got, want = runs["ranks"][0][f"{case}/a/loss"], runs["jax"][f"{case}/loss"]
    assert got.shape == want.shape == (C.STEPS,)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=0)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("case", list(CASES))
def test_state_matches_reference(runs, case, part):
    rank0 = runs["ranks"][0]
    for name in _names(runs, case):
        _close(rank0[f"{case}/a/whole/{part}/{name}"],
               runs["jax"][f"{case}/{part}/{name}"], f"{case} {part} {name}")


@pytest.mark.parametrize("case", DENSE)
def test_dense_matches_one_process_step(runs, case):
    rank0 = runs["ranks"][0]
    np.testing.assert_allclose(rank0[f"{case}/a/loss"],
                               rank0[f"{case}/one/loss"], rtol=LOSS_REL)
    for part in PARTS:
        for name in _names(runs, case):
            _close(rank0[f"{case}/a/whole/{part}/{name}"],
                   rank0[f"{case}/one/{part}/{name}"],
                   f"{case} {part} {name}")


def _block(whole, spec, names, coord):
    """The slice of `whole` that a rank at mesh coordinate `coord`
    ({name: index}) holds under `spec` (the first name of an entry
    major)."""
    sizes = dict(zip(names.mesh_dim_names, names.shape))
    index = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        i, n = 0, 1
        for a in axes:
            i, n = i * sizes[a] + coord[a], n * sizes[a]
        step = whole.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return whole[tuple(index)]


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_are_their_spec_slices(runs, case):
    _, arch, shape, style, n_experts = CASES[case]
    cfg = C.config(tconfigs, arch, n_experts)
    mesh = TS.MeshShape(shape)
    specs = TS.param_specs(cfg, mesh, tmodel.param_shapes(cfg), style=style)
    rank0 = runs["ranks"][0]
    for r, rank in enumerate(runs["ranks"]):
        coord = dict(zip(shape, rank[f"{case}/coordinate"].tolist()))
        for part in PARTS:
            for name, spec in specs.items():
                got = rank[f"{case}/a/block/{part}/{name}"]
                want = _block(rank0[f"{case}/a/whole/{part}/{name}"], spec,
                              mesh, coord)
                assert np.array_equal(got, want), (r, part, name, spec)


@pytest.mark.parametrize("case", list(CASES))
def test_bitwise_across_ranks_and_runs(runs, case):
    ranks = runs["ranks"]
    first = ranks[0][f"{case}/a/loss"]
    for rank in ranks:
        for tag in ("a", "b"):
            assert np.array_equal(rank[f"{case}/{tag}/loss"], first)
        for key in rank:
            if key.startswith(f"{case}/a/"):
                b = key.replace(f"{case}/a/", f"{case}/b/", 1)
                assert np.array_equal(rank[key], rank[b]), key


@pytest.mark.parametrize("case", list(CASES))
def test_step_traffic_is_what_the_collectives_move(runs, case):
    """What each rank's parameter gathers and gradient sums received in a
    step equals `step_traffic`'s reckoning from the step's plan."""
    _, arch, shape, style, n_experts = CASES[case]
    cfg = C.config(tconfigs, arch, n_experts)
    want = step_traffic(cfg, TS.MeshShape(shape), style=style)
    for rank in runs["ranks"]:
        assert rank[f"{case}/moved"].tolist() == [want["gather"],
                                                  want["grad_sum"]]
