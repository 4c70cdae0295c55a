"""The port's host syncs a query: its ``grs.<op>.sync`` spans in the profiled trace, per query.

Each read of a device value by the host inside the port opens one such
span (``gpuradixsort_tpu_torch/utils/trace.py``); the benchmark's own
reads of the answer are not among them.  None as for ``sync_idle_ms``.
"""

from qbench.metrics.sync_idle_ms import is_sync, queries_of


def read(run):
    queries = queries_of(run.trace)
    if queries is None:
        return None
    return sum(is_sync(n) for n, _, _ in run.trace.spans) / queries
