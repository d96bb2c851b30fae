"""Solves from one caller in a closed loop: `blas.solve(K̂, y_i,
precond=P)` from x0 = 0, each one started when the last has returned,
y_i from the configuration's system (`rhs`), each solution left on the
device until the check. The ladder reads each solve's status, so a
solve has ended on the card when it returns; the window closes with
one synchronisation all the same.

A solve counts as failed, and keeps no answer, when the ladder raised
(`RecoveryError`), or its answer came from a later rung than the first
(`len(result.attempts) > 1`), or its first rung did not converge or
ran out of iterations.
"""
from __future__ import annotations

import sys
import time

from portbench import core


def _solve(run, i: int):
    """One solve of the program, looked up when called (a control
    replaces `blas.solve`)."""
    from repro_torch import blas

    return blas.solve(run.inputs["K"], run.system.rhs(run, i),
                      **run.system.solve_args(run))


def warm(run) -> None:
    warm_solves = int(run.traffic["warm_solves"])
    for i in range(warm_solves):
        _solve(run, i)
    run.state["next"] = warm_solves


def window(run, seconds: float) -> core.Window:
    from repro_torch import blas

    max_iters = int(run.config["max_iters"])
    win = core.Window()
    i = int(run.state.get("next", 0))
    core.sync(run.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        try:
            res = _solve(run, i)
        except blas.RecoveryError:
            win.failed += 1
        else:
            first = res.attempts[0]
            if len(res.attempts) > 1 or first.status_name != "CONVERGED" \
                    or first.iterations >= max_iters:
                win.failed += 1
            else:
                win.answers.append((i, res.x, first.iterations,
                                    first.residual))
        i += 1
    core.sync(run.device)
    win.elapsed_s = time.perf_counter() - t0
    win.calls = len(win.answers)
    run.state["next"] = i
    its = [a[2] for a in win.answers]
    print(f"portbench: solve window: {win.calls} solves, {win.failed} "
          f"failed, {sum(its)} iterations ({min(its, default=0)} to "
          f"{max(its, default=0)}), {win.elapsed_s} s", file=sys.stderr)
    return win
