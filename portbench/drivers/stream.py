"""A stream of program calls from one caller: `blas.compile(spec)` once
in set-up, then `run(**inputs)` back to back with no synchronisation,
each call's inputs from the configuration's system (`call_inputs`), each
result left on the device until the window ends. The window closes with
one synchronisation after the last call it issued.
"""
from __future__ import annotations

import time

from portbench import core


def _program(run):
    from repro_torch import blas, core as rcore

    exe = run.state.get("exe")
    if exe is None:
        cfg = run.config
        exe = blas.compile(getattr(rcore, cfg["program"]), mode=cfg["mode"],
                           device=run.device)
        run.state["exe"] = exe
    return exe


def warm(run) -> None:
    exe = _program(run)
    for i in range(int(run.traffic["warm_calls"])):
        exe.run(**run.system.call_inputs(run, i))


def window(run, seconds: float) -> core.Window:
    exe = _program(run)
    inputs = run.system.call_inputs
    win = core.Window()
    i = int(run.state.get("next", 0))
    core.sync(run.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out = exe.run(**inputs(run, i))
        win.answers.append((i, out.one()))
        i += 1
    core.sync(run.device)
    win.elapsed_s = time.perf_counter() - t0
    win.calls = len(win.answers)
    run.state["next"] = i
    return win


def probe(run) -> list:
    """Host seconds for `run` to return, each call issued on an idle
    card (a synchronisation before each round), so that a full launch
    queue does not hold the host."""
    exe = _program(run)
    t = run.traffic
    out = []
    i = int(run.state.get("next", 0))
    for _ in range(int(t["probe_rounds"])):
        core.sync(run.device)
        for _ in range(int(t["probe_calls"])):
            args = run.system.call_inputs(run, i)
            t0 = time.perf_counter()
            exe.run(**args)
            out.append(time.perf_counter() - t0)
            i += 1
    core.sync(run.device)
    run.state["next"] = i
    return out
