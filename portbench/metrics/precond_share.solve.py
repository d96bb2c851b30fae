"""Device time of the kernels launched inside the preconditioner's
`loop.stage` spans (its `pcg_precond` stage program: the gemvt over L
and the gemv-anchored group over W), tied to their launches by the
trace's correlation ids, over the loop window's device busy time, in
percent."""
from portbench import solve_spans


def read(run):
    w = solve_spans.of(run)
    if w is None:
        return None
    busy = solve_spans.busy_ns(w)
    spent = solve_spans.precond_device_ns(w)
    if not busy or spent is None:
        return None
    return 100.0 * spent / busy
