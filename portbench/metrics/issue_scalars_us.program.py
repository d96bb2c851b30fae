"""Median over the `spans` window's calls of the duration of the call's
`window.scalars` spans, in microseconds: packing a launch's scalars,
and on the card the pinned upload and each tensor scalar's copy."""
from portbench import spans


def read(run):
    return spans.median_us(run, "window.scalars", self_time=False)
