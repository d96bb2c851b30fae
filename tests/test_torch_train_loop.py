"""The port's train loop and launcher on the CPU (the train step against
the reference's: tests/test_torch_train_step.py).

* `train_loop`: the reference's integration test
  (tests/test_train_serve_integration.py) on the port: the loss falls by
  more than 0.3 over 60 steps, and a restart resumes from step 60 and
  runs 20 more. Beyond it, an 80-step run resumed from its own step-60
  checkpoint logs the same losses as the uninterrupted run, bitwise.
* the launcher in a subprocess, and the refusals of what is not ported
  (sharded training, ROADMAP item 14.6b) or not present (no card and no
  device named).

The reduced model is tiny, and intra-op threads only cost it time when
the suite's workers share the host's cores: each test here runs torch
on one thread (`_torch_train.one_torch_thread`), the launcher's
subprocess likewise.
"""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import train_loop
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step

from _torch_train import one_torch_thread  # noqa: F401 (autouse)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


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
    with pytest.raises(ValueError, match="14.6b"):
        make_train_step(_tiny(), AdamW(), grad_specs={"embed": None})


def test_train_loop_refuses_a_mesh_of_several_ranks():
    mesh = types.SimpleNamespace(mesh=torch.arange(4).reshape(2, 2))
    with pytest.raises(ValueError, match="14.6b"):
        train_loop(_tiny(), mesh=mesh, steps=1, batch_size=1, seq_len=4,
                   device="cpu")


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
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "llama3-8b", "--reduced",
                      "--production-mesh", "--device", "cpu"])
