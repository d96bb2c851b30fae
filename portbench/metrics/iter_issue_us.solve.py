"""Median over the loop window's iterations of the `loop.iter` span's
self time, in microseconds: the loop driver's own host time an
iteration (its guards, status and history updates), outside the stop
read (`loop.stop`) and the stages (`loop.stage`)."""
import statistics

from portbench import solve_spans, spantrace


def read(run):
    w = solve_spans.of(run)
    if w is None:
        return None
    own = spantrace.self_ns(w.spans)
    its = [own[sid] for _, sid, _, _, _ in w.named(solve_spans.ITER)]
    return statistics.median(its) / 1e3 if its else None
