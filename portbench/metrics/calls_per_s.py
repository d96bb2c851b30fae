"""Program calls completed per second: the calls issued in the measured
window over its host-clock length, the last one synchronised inside it."""


def read(run):
    w = run.windows["timed"]
    return w.calls / w.elapsed_s
