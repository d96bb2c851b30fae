"""The port's train loop and launcher on the CPU (the train step against
the reference's: tests/test_torch_train_step.py).

* `train_loop`: the reference's integration test
  (tests/test_train_serve_integration.py) on the port: the loss falls by
  more than 0.3 over 60 steps, and a restart resumes from step 60 and
  runs 20 more. Beyond it, an 80-step run resumed from its own step-60
  checkpoint logs the same losses as the uninterrupted run, bitwise.
* the launcher in a subprocess, and the refusals of what is not present
  (no card and no device named, a production mesh's 256 or 512 ranks).
* sharded training in a 4-rank gloo world (a process per rank,
  tests/_torch_shard_check.py `loop`): two steps of
  `make_train_step(grad_specs=)` on a ("data" 2, "model" 2) mesh against
  the one-process step (losses within 1e-5 relative, parameters within
  2e-5: AdamW's first update from zero moments, lr g / (|g| + eps), moves
  an element whose gradient is ~1e-8 by a share of lr that the float
  sums' order decides); `train_loop(mesh=)` on that mesh with
  checkpoints, restored in one process from its step-4 checkpoint (the
  elastic restore): the resumed losses within 1e-4 relative of the
  uninterrupted run's; and the launcher in four processes over the
  `torch.distributed` environment (gloo, `--device cpu`).

The reduced model is tiny, and intra-op threads only cost it time when
the suite's workers share the host's cores: each test here runs torch
on one thread (`_torch_train.one_torch_thread`), the launcher's
subprocess likewise.
"""
import dataclasses
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import train_loop
from repro_torch.models import init_params, sharding
from repro_torch.optim import AdamW
from repro_torch.train import (make_train_state, make_train_step,
                               state_tree, step_traffic)

import _torch_shard_check as C
from _torch_train import one_torch_thread  # noqa: F401 (autouse)

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
LOOP_WORLD = 4


def _tiny():
    return dataclasses.replace(tconfigs.get_config("llama3-8b").reduced(),
                               dtype="float32")


def _stream(cfg):
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, batch_size=8,
                       seed=0, branching=2)


def _loop(cfg, steps, ckpt_dir, ckpt_every):
    return train_loop(cfg, steps=steps, batch_size=8, seq_len=32,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, lr=3e-3,
                      remat=False, log_every=5, stream=_stream(cfg),
                      device="cpu")


def test_train_loss_decreases_and_restart_resumes(tmp_path):
    cfg = _tiny()
    res1 = _loop(cfg, 60, tmp_path, 30)
    first_loss = res1.losses[0][1]
    assert res1.restored_from is None and res1.steps_run == 60
    assert res1.final_loss < first_loss - 0.3, res1.losses
    res2 = _loop(cfg, 80, tmp_path, 40)
    assert res2.restored_from == 60
    assert res2.steps_run == 20
    assert res2.final_loss < first_loss
    assert [s for s, _ in res2.losses] == [65, 70, 75, 80]


def test_resumed_losses_equal_uninterrupted_run_bitwise(tmp_path):
    cfg = _tiny()
    whole = _loop(cfg, 80, tmp_path / "whole", 20)
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    shutil.copytree(tmp_path / "whole" / "step_0000000060",
                    resumed_dir / "step_0000000060")
    resumed = _loop(cfg, 80, resumed_dir, 20)
    assert resumed.restored_from == 60 and resumed.steps_run == 20
    assert resumed.losses == [(s, l) for s, l in whole.losses if s > 60]


def test_train_step_refuses_grad_specs():
    """grad_specs need a state placed on a mesh."""
    cfg = _tiny()
    optim = AdamW()
    state = make_train_state(cfg, init_params(cfg, 0, device="cpu"), optim)
    step = make_train_step(cfg, optim, grad_specs={"embed": None})
    with pytest.raises(ValueError, match="placed on a mesh"):
        step(state, _stream(cfg).batch_at(0))


def test_train_loop_refuses_a_mesh_of_several_ranks():
    """... whose batch blocks the global batch does not fill (checked
    from the mesh's names and sizes, before any collective)."""
    mesh = sharding.MeshShape({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="does not split"):
        train_loop(_tiny(), mesh=mesh, steps=1, batch_size=1, seq_len=4,
                   device="cpu")


def _env(**extra):
    """A child's environment: this source tree, one thread, no world of
    the parent's."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", **extra)
    return env


def _run_all(cmds, envs, timeout):
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(cmds, envs)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, bad
    return outs


@pytest.fixture(scope="module")
def loop_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop_world")
    _run_all([[sys.executable, str(HERE / "_torch_shard_check.py"), "loop",
               str(tmp), str(r), str(LOOP_WORLD)]
              for r in range(LOOP_WORLD)], [_env()] * LOOP_WORLD, 240)
    return tmp, [dict(np.load(tmp / f"loop_{r}.npz"))
                 for r in range(LOOP_WORLD)]


def test_train_step_grad_specs_on_a_4_rank_mesh(loop_world):
    _, ranks = loop_world
    cfg = C.loop_config()
    optim = AdamW(lr=1e-3)
    state = make_train_state(cfg, init_params(cfg, 0, device="cpu"), optim)
    step = make_train_step(cfg, optim)
    stream = C.loop_stream(cfg)
    want = [float(step(state, stream.batch_at(i))[1]["loss"])
            for i in range(2)]
    whole = state_tree(state)["params"]
    for rank in ranks:
        assert np.array_equal(rank["losses"], ranks[0]["losses"])
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5)
        for name, t in whole.items():
            np.testing.assert_allclose(rank[f"params/{name}"], t.numpy(),
                                       rtol=0, atol=2e-5, err_msg=name)


def test_step_traffic_is_what_the_collectives_move(loop_world):
    """`train.step_traffic`'s reckoning of a step's gather and
    gradient-sum bytes equals what each rank's collectives received."""
    _, ranks = loop_world
    cfg = C.loop_config()
    data, model = C.LOOP_MESH
    want = step_traffic(
        cfg, sharding.MeshShape({"data": data, "model": model}))
    for rank in ranks:
        assert rank["moved"].tolist() == [want["gather"],
                                          want["grad_sum"]]


def test_train_loop_on_a_mesh_restores_on_one_process(loop_world):
    tmp, ranks = loop_world
    cfg = C.loop_config()
    whole = ranks[0]["loop_losses"]
    assert whole.shape == (C.LOOP_STEPS,)
    assert all(np.array_equal(r["loop_losses"], whole) for r in ranks)
    resumed_dir = tmp / "resumed"
    resumed_dir.mkdir()
    name = f"step_{C.LOOP_CKPT:010d}"
    shutil.copytree(tmp / "ckpt" / name, resumed_dir / name)
    res = train_loop(cfg, steps=C.LOOP_STEPS, batch_size=C.LOOP_BATCH,
                     seq_len=C.LOOP_SEQ, ckpt_dir=resumed_dir,
                     ckpt_every=C.LOOP_CKPT, lr=3e-3, log_every=1,
                     stream=C.loop_stream(cfg), device="cpu")
    assert res.restored_from == C.LOOP_CKPT
    assert [s for s, _ in res.losses] == list(range(C.LOOP_CKPT + 1,
                                                    C.LOOP_STEPS + 1))
    np.testing.assert_allclose([l for _, l in res.losses],
                               whole[C.LOOP_CKPT:], rtol=1e-4)


def test_launcher_trains_on_a_4_rank_gloo_world():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3-8b", "--reduced", "--steps", "4", "--batch", "8",
           "--seq", "16", "--device", "cpu"]
    outs = _run_all([cmd] * LOOP_WORLD, [
        _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
             LOCAL_RANK=str(r), WORLD_SIZE=str(LOOP_WORLD))
        for r in range(LOOP_WORLD)], 240)
    assert "step     4 loss" in outs[0] and "final loss:" in outs[0]
    assert all("final loss:" not in o for o in outs[1:])


def test_launcher_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--reduced", "--steps", "20", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step    20 loss" in proc.stdout
    assert "final loss:" in proc.stdout and "on cpu" in proc.stdout


def test_launcher_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "llama3-8b", "--reduced", "--steps", "1"])
    for flag, ranks in (("--production-mesh", 256), ("--multipod", 512)):
        with pytest.raises(SystemExit, match=f"world of {ranks} ranks"):
            tlaunch.main(["--arch", "llama3-8b", "--reduced", flag,
                          "--device", "cpu"])
