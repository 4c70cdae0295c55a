"""Base-table rows the completed queries read, over the window's seconds."""


def read(run):
    if not run.latencies_s:
        return None
    return len(run.latencies_s) * run.rows_per_query / run.window_s
