"""The card's idle time whose gap middle lies inside a `loop.iter` span,
over the loop window's `loop.iter` spans (one an iteration), in
microseconds: the device time an
iteration loses to the loop driver's host (its stop read's round trip
and the launches after it)."""
from portbench import solve_spans, spantrace


def read(run):
    w = solve_spans.of(run)
    if w is None or not w.events or \
            not any(dev for _, dev, _, _ in w.events):
        return None
    its = w.named(solve_spans.ITER)
    if not its:
        return None
    idle = spantrace.idle_under(w.events, w.spans, solve_spans.ITER)
    return idle / len(its) / 1e3
