"""Median host milliseconds for one `run` of the program to return,
unsynchronised, each issued while the card's launch queue has room (the
stream driver's probe before the traced window)."""
import statistics


def read(run):
    if not run.probe_s:
        return None
    return 1e3 * statistics.median(run.probe_s)
