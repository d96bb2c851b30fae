"""The sharded train step in a gloo world of one (the only world a card
host with one card can show; `chip_smoke.py` phase 2j runs it on NCCL):
for reduced llama3-8b (2 layers) and deepseek-moe-16b (MoE: the EP
variant in "2d", the local dispatch in "fsdp") on ("data", "model") (1,
1) and ("pod", "data", "model") (1, 1, 1) meshes in both styles, two
steps with `grad_specs` from the seed of the unsharded step:

* the losses, every parameter and both moments bitwise the unsharded
  step's;
* no second copy of the weights: placing the state keeps each tensor
  where it was, and gathering a block returns the tensor itself.

The world runs in a subprocess (tests/_torch_shard_check.py `one`), so
no process group touches the pytest process.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
CHECK = HERE / "_torch_shard_check.py"
SRC = str(HERE.parent / "src")

sys.path.insert(0, str(HERE))
import _torch_shard_check as C  # noqa: E402

IDS = [f"{arch}-{'x'.join(map(str, shape.values()))}-{style}"
       for arch, shape, style in C.ONE_CASES]


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(CHECK), "one", str(tmp)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "one.npz"))


@pytest.mark.parametrize("case", range(len(C.ONE_CASES)), ids=IDS)
def test_world_of_one_is_bitwise_the_unsharded_step(one, case):
    sharded, plain = one[f"{case}/loss"]
    assert np.array_equal(sharded, plain), (sharded, plain)
    for part in ("params", "m", "v"):
        assert bool(one[f"{case}/{part}/same"]), part


@pytest.mark.parametrize("case", range(len(C.ONE_CASES)), ids=IDS)
def test_world_of_one_holds_no_second_copy(one, case):
    assert bool(one[f"{case}/aliased"])
