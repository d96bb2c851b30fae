"""The card's idle time whose gap middle lies inside a `program.call`
span, as a percentage of the `spans` window's length (its trace's first
event to its last). The window's whole idle share less this is the idle
that the caller's own code between calls causes."""
from portbench import spans, spantrace


def read(run):
    w = spans.of(run)
    if w is None or not w.events or not any(d for _, d, _, _ in w.events) \
            or not any(n == spans.CALL for n, _, _, _, _ in w.spans):
        return None
    lo, hi = spantrace.window_of(w.events)
    return 100.0 * spantrace.idle_under(w.events, w.spans, spans.CALL) \
        / (hi - lo)
