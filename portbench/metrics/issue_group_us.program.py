"""Median over the `spans` window's calls of the self time of the
call's `kernel.group` spans, in microseconds: the host's time in the
emitted program's group loop and the generated group's callable,
outside the launches it makes."""
from portbench import spans


def read(run):
    return spans.median_us(run, "kernel.group")
