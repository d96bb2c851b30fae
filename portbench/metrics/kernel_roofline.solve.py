"""The least time the card could take for the traced window's solves, as
the harness reckons it from the configuration's shapes and the float64
reference's iterations on each solve's right-hand side
(`portbench/gp_work.py`), over the device's busy time, in percent."""


def read(run):
    t = run.trace_summary
    win = run.windows.get("traced")
    if not t or win is None or t["busy_s"] <= 0:
        return None
    least = run.system.least_seconds(run, win)
    if least is None:
        return None
    return 100.0 * least / t["busy_s"]
