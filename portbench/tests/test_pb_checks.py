"""The comparison that decides `correct`, at a size a test run holds:
the control (the reference in TF32 in the program's place) makes a whole
run come out not correct, and so does a run with the timed path broken
underneath, once for each fault the cell can have."""
import time

import pytest
import torch

from portbench import core

from .test_pb_manifest import TINY

CELL = "axpydot-stream"


def _run(seed=2 ** 31 + 5, seconds=0.15, setup=None):
    cfg, traffic = TINY[CELL]
    run = core.prepare(CELL, seed, seconds, 0, "cpu",
                       config_overrides=cfg, traffic_overrides=traffic)
    if setup is not None:
        setup(run)
    return core.execute(run, time.perf_counter())


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17, 4_000_000_123])
def test_control_fails_and_the_program_passes(seed, monkeypatch, store):
    line = _run(seed)
    assert line["correct"] is True, line["checks"]
    control = _run(seed, setup=lambda run: run.system.use_control(
        monkeypatch.setattr))
    assert control["correct"] is False
    assert control["attempted"] > 0 and control["failed"] == 0
    for name, c in control["checks"].items():
        reading = line["checks"][name]["value"]
        assert c["value"] > c["limit"] > reading, (name, c, reading)
        assert c["value"] >= 3 * reading


def _stale(first):
    def alter(out, inputs):
        first.setdefault("r", out)
        return first["r"]
    return alter


def _half_vector(out, inputs):
    h = inputs["w"].shape[0] // 2
    z = inputs["w"][:h] + inputs["neg_alpha"] * inputs["v"][:h]
    return 2.0 * torch.dot(z, inputs["u"][:h])


FAULTS = {
    "state unchanged": None,
    "answer altered": lambda out, inputs: out * (1.0 + 1e-3),
    "half the vector left out": _half_vector,
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_program_is_not_correct(fault, monkeypatch, store):
    alter = FAULTS[fault] or _stale({})
    line = _run(setup=lambda run: run.system.replace_answers(
        alter, monkeypatch.setattr))
    assert line["correct"] is False
    assert line["checks"]["r_err_max"]["value"] > \
        line["checks"]["r_err_max"]["limit"]
