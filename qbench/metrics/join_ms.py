"""Host ms a query in joins: every ``join`` span over the window, over the queries completed.

A span runs from the call of ``join`` to the end of its ``to_table()``,
which waits for the device.
"""


def read(run):
    if run.spans is None or "join" not in run.spans or not run.latencies_s:
        return None
    return run.spans["join"] / len(run.latencies_s) * 1e3
