"""The share of the profiled queries' wall time in which no device activity ran."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s) * 100
