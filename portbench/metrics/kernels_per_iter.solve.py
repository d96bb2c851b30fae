"""Device kernels in the traced window (copies and fills left out) over
the iterations its solves reported (each solve's first rung): the
launches the fusion plan, the generated groups and the loop driver
make of one iteration, a solve's set-up spread over its iterations."""


def read(run):
    t = run.trace_summary
    win = run.windows.get("traced")
    if not t or t["busy_s"] <= 0 or win is None or not win.answers:
        return None
    iterations = sum(a[2] for a in win.answers)
    return t["kernels"] / iterations if iterations else None
