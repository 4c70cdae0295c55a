"""Group-by aggregation over columnar tables: sort, then reduce each run.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/aggregate.py``.  A stable
sort brings equal keys together; each run of equal keys is one segment.
The JAX package gathers the value columns through the sort's permutation
(``sort_table``), takes a segmented prefix combine (``associative_scan``),
whose results are per row, and compacts the run ends to the front.  Here
one kernel, ``kernels/aggregate.py::segment_aggregate``, does all three: it
reads each column through the permutation, writes each group's key and
aggregates once, at its slot in key order, and zeroes the rows past the
group count, as the JAX package does.

Integer sums wrap to 32 bits, the int32 (or uint32) sum modulo 2^32.
Float sums are taken in float64 and rounded to float32 once, so they are at
least as close to the exact sum as the JAX package's float32 tree.
``mean`` is the float32 sum of the values cast to float32, divided by the
float32 count.

Aggregation kinds: sum, count, min, max, mean.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Column, Table, int32_bits
from gpuradixsort_tpu_torch.kernels.aggregate import SUPPORTED, segment_aggregate
from gpuradixsort_tpu_torch.ops.filter import Selection
from gpuradixsort_tpu_torch.ops.sort import sort_pairs
from gpuradixsort_tpu_torch.utils import trace

def aggregate_sorted_flat(
    keys: torch.Tensor,
    n_live,
    inputs: Sequence[tuple[str, torch.Tensor | None, str]],
    rows: torch.Tensor | None = None,
):
    """Aggregate a key-sorted padded buffer per run of equal keys.

    ``keys``: (padded,) uint32 sorted ascending with live rows first;
    ``n_live``: an int or a 0-d tensor on the keys' device.  ``inputs``:
    (out_name, values or None, kind); None is only valid for "count".
    ``rows``: None, each column in key order already; or the sort's int32
    permutation, of the keys' length on their device, through which the
    unsorted columns are read (``segment_aggregate``).
    Returns ``(group_keys, {name: values}, count)``, compacted to the front,
    one row per group, rows >= count zero.  count is a 0-d int32 tensor.
    On the card this is ``segment_aggregate``'s kernel and makes no host
    sync.  The JAX package's ``cfg`` sets the tiles of its compaction; there
    is no compaction here, so the port takes none.  Counts the live and
    padded rows at the ``aggregate`` site (``trace.rows``) where ``n_live``
    is an int; a tensor's count is left out, since reading it is a sync.
    """
    if not isinstance(n_live, torch.Tensor):
        trace.rows("aggregate", n_live, keys.numel())
    return segment_aggregate(keys, n_live, inputs, rows)


def group_by_aggregate(
    table: Table,
    key: str,
    aggs: Mapping[str, tuple[str, str]],
    cfg: EngineConfig | None = None,
    method: str = "auto",
) -> Selection:
    """Group ``table`` by uint32 column ``key`` and aggregate.

    ``aggs`` maps output column name -> (input column name, kind) with kind
    one of sum/count/min/max/mean.  Returns a Selection whose table holds one
    row per group (keys ascending), with the group count as a 0-d tensor.
    The value columns are read through the sort's permutation, never
    gathered into sorted copies.
    """
    cfg = cfg or EngineConfig()
    for out_name, (col, kind) in aggs.items():
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind != "count" and col not in table.columns:
            raise KeyError(f"aggregation input column {col!r} not in table")

    with trace.span("grs.group_by"):
        sorted_keys, perm = sort_pairs(table[key], cfg, method)
        inputs = [
            (out_name, None if kind == "count" else table[col].data, kind)
            for out_name, (col, kind) in aggs.items()
        ]
        with trace.span("grs.group_by.aggregate"):
            group_keys, out, count = aggregate_sorted_flat(sorted_keys.data, table.length,
                                                           inputs, int32_bits(perm.data))
        n = table.length
        result: dict[str, Column] = {key: Column(group_keys, n)}
        for out_name, vals in out.items():
            result[out_name] = Column(vals, n)
        return Selection(Table(result), count, "grs.group_by")
