"""The port's own spans and counters: what its operators did, beside the kernels' trace.

Spans.  ``span(name)`` opens ``torch.profiler.record_function(name)``
while the profiler records on the calling thread, so the span lies in the
same trace as the kernels, copies and memsets, on one clock; otherwise it
returns one shared no-op context.  The profiler being on is the switch:
there is no flag.  The operators open one span a call and one a phase,
never one a kernel launch:

- ``grs.sort``: a sort (``sort_keys``, ``sort_pairs``, ``sort_table``),
  one span even where one entry calls another;
- ``grs.filter``: ``filter_table``'s mask and compaction;
- ``grs.join``: ``join`` and ``join_expand``, with the phases
  ``grs.join.build`` (the build side's sort) and ``grs.join.probe`` (the
  searches and the payload gathers); the compaction is a nested
  ``grs.filter``;
- ``grs.group_by``: ``group_by_aggregate``, its sort a nested
  ``grs.sort``, with the phase ``grs.group_by.aggregate``;
- ``grs.<op>.sync``: every read of a device value by the host inside the
  port (``Selection.to_table()`` named by the operator that made the
  selection, ``ExpandedJoin.to_table()``, ``join(validate_unique=True)``,
  ``skipped_passes()``, ``Column.to_numpy()`` as ``grs.column.sync``).

Counters.  ``rows(site, live, walked)`` adds the live rows of a buffer
and the rows the port's kernels or torch calls walk over it, always on:
host integers, read from the columns' host lengths, never a sync.  The
sites: ``sort`` (each sort of a key column), ``compact`` (a filter's
compaction), ``probe`` (each search of a join's probe keys: ``join``'s
walks the live rows rounded up to its kernel's tile), ``gather``
(each index through which an operator gathers payload columns, once an
index) and ``aggregate`` (the group-by's kernel, where its live length is
a host integer).  ``gather_filled(rows)`` counts, of the ``gather`` site's
walked rows, those written from each column's row 0 with no read of the
index (``sort_table``'s pad rows), once an index; ``probe_filled(rows)``
the pad rows ``join``'s probe writes past the rows it searches, with no
read of their keys.  ``counters()`` reads
them with the counts the port already keeps: every kernel wrapper's
``.launches``, the sort graphs made and replayed, and the passes the
fused sorts skipped.
"""

from __future__ import annotations

import contextlib

import torch

SITES = ("sort", "compact", "probe", "gather", "aggregate")

_NO_SPAN = contextlib.nullcontext()
_rows = {site: [0, 0] for site in SITES}
_graphs_captured = 0
_gather_filled = 0
_probe_filled = 0


def span(name: str):
    """A context that names its work ``name`` in the profiler's trace while it records.

    With the profiler off, the one shared no-op context: no allocation and
    no clock read, one check of the profiler's state.
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def rows(site: str, live: int, walked: int) -> None:
    """Count ``live`` rows of a buffer at ``site`` (one of ``SITES``) and the ``walked`` rows."""
    count = _rows[site]
    count[0] += live
    count[1] += walked


def gather_filled(rows: int) -> None:
    """Count ``rows`` pad rows of a gather written from each column's row 0, the index unread."""
    global _gather_filled
    _gather_filled += rows


def probe_filled(rows: int) -> None:
    """Count ``rows`` pad rows of a join's probe written without a search, their keys unread."""
    global _probe_filled
    _probe_filled += rows


def graph_captured() -> None:
    """Count one CUDA graph made by the sorts' cache (``ops/sort.py::_graph_of``)."""
    global _graphs_captured
    _graphs_captured += 1


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each keeps its own ``.launches``."""
    from gpuradixsort_tpu_torch.kernels import (
        aggregate,
        bucketize,
        gather,
        probe,
        radix,
        scan,
        scatter,
        sort_plan,
    )

    return {
        "radix_hist": radix.tile_histograms,
        "bucketize": bucketize.bucketize_tiles,
        "scatter_runs": scatter.scatter_runs,
        "bucketize_scatter_lookback": scatter.bucketize_scatter_lookback,
        "sort_plan": sort_plan.sort_plan,
        "sort_args": sort_plan.sort_args,
        "radix_dest": radix.tile_destinations,
        "dest_scatter": radix.dest_scatter,
        "exclusive_scan": scan.exclusive_scan,
        "segment_aggregate": aggregate.segment_aggregate,
        "gather_rows": gather.gather_columns,
        "join_probe": probe.join_probe,
    }


def counters() -> dict:
    """One snapshot of the port's counts.

    - ``rows``: {site: [live, walked]} since the last ``reset()``;
    - ``gather_filled``: the pad rows the gathers wrote from row 0 since
      the last ``reset()``;
    - ``probe_filled``: the pad rows ``join``'s probes wrote without a
      search since the last ``reset()``.  With the ``probe`` site's walked
      rows it says how much of the probes' padded rows the search skipped;
      no metric reads it;
    - ``launches``: {wrapper: launches}, each wrapper's own count;
    - ``graphs``: ``captured``, the sort graphs made since the last
      ``reset()``, and ``replayed``, the replays of the graphs the cache
      holds now.  Captures that keep rising after a warm-up mean the
      traffic has more recurring sort shapes than the cache keeps;
    - ``passes_skipped``: ``skipped_passes()``, which reads the card's
      counters back, a host sync: take the snapshot after the work.
    """
    from gpuradixsort_tpu_torch.ops import sort

    return {
        "rows": {site: list(count) for site, count in _rows.items()},
        "gather_filled": _gather_filled,
        "probe_filled": _probe_filled,
        "launches": {name: fn.launches for name, fn in kernel_wrappers().items()},
        "graphs": {"captured": _graphs_captured,
                   "replayed": sum(g.replays for g in sort._SORT_GRAPHS.values())},
        "passes_skipped": sort.skipped_passes(),
    }


def reset() -> None:
    """Zero the row counts, the filled pad rows and the graphs made; the rest are their owners'."""
    global _gather_filled, _probe_filled, _graphs_captured
    for count in _rows.values():
        count[0] = count[1] = 0
    _gather_filled = _probe_filled = _graphs_captured = 0
