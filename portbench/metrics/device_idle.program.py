"""The card's idle share of the traced window, in percent: one less the
device's busy seconds (the union of the device operations' intervals)
over the window's length, both read from the trace."""


def read(run):
    t = run.trace_summary
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
