"""Device idle ms a query that falls to the port's host syncs.

Of the profiled queries' idle gaps (``devicetime.Trace.idle_gaps``), the
ones whose innermost open span at the gap's start is one of the port's
sync spans, ``grs.<op>.sync`` (``gpuradixsort_tpu_torch/utils/trace.py``):
the host reading a device value while the device drains, then building
the next operator while the device waits.  Summed, in ms, over the
profiled queries.  None without a trace, or where the trace holds no span
of the port (a port that opens none).
"""

from qbench.devicetime import QUERY_SPAN

PORT = "grs."  # the prefix of the port's spans
SYNC = ".sync"  # the suffix of its sync spans


def is_sync(name: str) -> bool:
    return name.startswith(PORT) and name.endswith(SYNC)


def queries_of(trace) -> int | None:
    """The profiled queries, or None where the trace has none or no span of the port."""
    if trace is None:
        return None
    names = [n for n, _, _ in trace.spans]
    queries = names.count(QUERY_SPAN)
    if not queries or not any(n.startswith(PORT) for n in names):
        return None
    return queries


def idle_ms(run, named) -> float | None:
    """Ms a query of the idle gaps whose span's name passes ``named``."""
    queries = queries_of(run.trace)
    if queries is None:
        return None
    return sum(gap for name, gap in run.trace.idle_gaps() if named(name)) / queries * 1e3


def read(run):
    return idle_ms(run, is_sync)
