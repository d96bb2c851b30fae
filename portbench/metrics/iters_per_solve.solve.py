"""The program's `loop.iterations` counter over the solves that the loop
window completed: the loop driver's iterations a solve."""
from portbench import solve_spans


def read(run):
    w = solve_spans.of(run)
    if w is None or not w.window.calls or \
            solve_spans.ITERATIONS not in w.counters:
        return None
    return solve_spans.iterations(w) / w.window.calls
