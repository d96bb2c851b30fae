"""Median over the `spans` window's calls of the `program.call` span's
self time, in microseconds: the host's time in the public API and the
runtime (`Executable.run`, `Program.__call__`, the emitted program's
bindings), outside every group of the call."""
from portbench import spans


def read(run):
    return spans.median_us(run, "program.call")
