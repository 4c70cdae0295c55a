"""Device idle ms a query inside the port's operators but outside their host syncs.

The profiled queries' idle gaps whose innermost open span at the gap's
start is a span of the port (``grs.``) other than a sync span: the host
launching an operator's work more slowly than the device runs it.  Summed,
in ms, over the profiled queries.  Idle outside any span of the port is
the plan's glue or the benchmark's, and counts here and in
``sync_idle_ms`` neither.  None as for ``sync_idle_ms``.
"""

from qbench.metrics.sync_idle_ms import PORT, idle_ms, is_sync


def read(run):
    return idle_ms(run, lambda name: name.startswith(PORT) and not is_sync(name))
