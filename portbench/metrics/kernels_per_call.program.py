"""Device kernels in the traced window per program call it completed
(copies and fills left out): how many launches the fusion plan and the
generated groups make of one call."""


def read(run):
    t = run.trace_summary
    win = run.windows.get("traced")
    if not t or t["busy_s"] <= 0 or win is None or not win.calls:
        return None
    return t["kernels"] / win.calls
