"""Seconds from the start of the process to the first timed call:
imports, kernel builds or loads, inputs made from the seed, warm-up."""


def read(run):
    return run.setup_s
