"""Median over the `spans` window's calls of the self time of the
call's `window.launch` spans, in microseconds: the host's time in
`kernels/window.py::launch` (buffers, grid, both Triton launches),
outside the scalar block. Nothing to read where no pass runs on a card."""
from portbench import spans


def read(run):
    return spans.median_us(run, "window.launch")
