"""Host ms a query in the group-by: its spans over the window, over the queries completed.

A span runs from the call of ``group_by_aggregate`` to the end of its
``to_table()``, which waits for the device.
"""


def read(run):
    if run.spans is None or "groupby" not in run.spans or not run.latencies_s:
        return None
    return run.spans["groupby"] / len(run.latencies_s) * 1e3
