"""Group-by aggregation over columnar tables: sort, then reduce each run.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/aggregate.py``.  A stable
sort brings equal keys together; each run of equal keys is one segment.
The JAX package takes a segmented prefix combine (``associative_scan``,
plain XLA), whose results are per row, and compacts the run ends to the
front.  Here each segment is reduced once (``index_add_`` /
``scatter_reduce_`` over segment ids from a cumsum of the run starts) into
slot ``segment id``, which is already the compacted order: one row per
group, keys ascending.  Rows at or past the group count are zeroed, as in
the JAX package.

Integer sums are taken in int64 and wrap to 32 bits, which is the int32 (or
uint32) sum modulo 2^32.  Float sums are taken in float64 and rounded to
float32 once, so they are at least as close to the exact sum as the JAX
package's float32 tree.  ``mean`` is the float32 sum of the values cast to
float32, divided by the float32 count.

Aggregation kinds: sum, count, min, max, mean.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Column, Table, int32_bits, wrap_int32
from gpuradixsort_tpu_torch.ops.filter import Selection
from gpuradixsort_tpu_torch.ops.sort import sort_table

SUPPORTED = ("sum", "count", "min", "max", "mean")

_INT32_TYPES = (torch.int32, torch.uint32)


def _widen(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer column as int64 with its value (uint32 unsigned)."""
    wide = int32_bits(v).to(torch.int64)
    return wide & 0xFFFFFFFF if v.dtype == torch.uint32 else wide


def _narrow(wide: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The low 32 bits of int64 values, as ``dtype`` (int32 or uint32)."""
    return wrap_int32(wide).view(dtype)


def _segment_reduce(v: torch.Tensor, seg: torch.Tensor, live: torch.Tensor, kind: str):
    """Reduce ``v`` over the live rows of each segment; one result per segment id.

    v: (padded,) int32, uint32 or float32; seg: (padded,) int64 segment id of
    each row.  Returns a (padded,) tensor indexed by segment id, in v's
    dtype.  Rows that are not live add the kind's neutral element.
    """
    padded = v.shape[0]
    if v.dtype in _INT32_TYPES:
        wide = _widen(v)
    elif v.dtype == torch.float32:
        wide = v.to(torch.float64) if kind == "sum" else v
    else:
        raise TypeError(f"aggregation takes int32, uint32 or float32 columns, got {v.dtype}")
    if kind == "sum":
        acc = torch.zeros(padded, dtype=wide.dtype, device=v.device)
        acc.index_add_(0, seg, torch.where(live, wide, 0))
        return _narrow(acc, v.dtype) if v.dtype in _INT32_TYPES else acc.to(v.dtype)
    if wide.dtype == torch.int64:
        lo, hi = (0, 0xFFFFFFFF) if v.dtype == torch.uint32 else (-(1 << 31), (1 << 31) - 1)
    else:
        lo, hi = float("-inf"), float("inf")
    neutral = hi if kind == "min" else lo
    acc = torch.full((padded,), neutral, dtype=wide.dtype, device=v.device)
    acc.scatter_reduce_(0, seg, torch.where(live, wide, neutral),
                        "amin" if kind == "min" else "amax")
    return _narrow(acc, v.dtype) if v.dtype in _INT32_TYPES else acc


def aggregate_sorted_flat(
    keys: torch.Tensor,
    n_live,
    inputs: Sequence[tuple[str, torch.Tensor | None, str]],
):
    """Aggregate a key-sorted padded buffer per run of equal keys.

    ``keys``: (padded,) uint32 sorted ascending with live rows first;
    ``n_live``: an int or a 0-d tensor on the keys' device.  ``inputs``:
    (out_name, values or None, kind); None is only valid for "count".
    Returns ``(group_keys, {name: values}, count)``, compacted to the front,
    one row per group, rows >= count zero.  count is a 0-d int32 tensor.
    The JAX package's ``cfg`` sets the tiles of its compaction; there is no
    compaction here, so the port takes none.
    """
    padded = keys.shape[0]
    dev = keys.device
    pos = torch.arange(padded, device=dev)
    live = pos < n_live
    k = int32_bits(keys)

    # Run boundaries in sorted order.  A run ends where the next key differs
    # or at the buffer's end, and counts only if that row is live (a live key
    # equal to the pad key runs on into the pads, as in the JAX package).
    changed = k[1:] != k[:-1]
    edge = torch.ones(1, dtype=torch.bool, device=dev)
    is_first = torch.cat([edge, changed])
    is_last = torch.cat([changed, edge]) & live
    # Rows past the live prefix take their own slot (>= count, zeroed
    # below), not their run's: a shard's merged buffer is about half pad
    # rows, and one slot would take every pad row's atomic update.
    seg = torch.where(live, torch.cumsum(is_first, dim=0) - 1, pos)
    # The live rows are a prefix, so the runs that end on a live row are
    # segments 0..count-1, in key order.
    count = is_last.sum(dtype=torch.int32)
    valid_group = pos < count

    def zero_past_count(c: torch.Tensor) -> torch.Tensor:
        return torch.where(valid_group, int32_bits(c), 0).view(c.dtype)

    # Every row of a segment holds its key, so whichever row lands last in a
    # slot writes the same value.
    group_keys = torch.zeros_like(k).index_copy_(0, seg, k).view(keys.dtype)

    out: dict[str, torch.Tensor] = {}
    counts = None
    for out_name, v, kind in inputs:
        if kind in ("count", "mean") and counts is None:
            counts = _segment_reduce(torch.ones(padded, dtype=torch.int32, device=dev),
                                     seg, live, "sum")
        if kind == "count":
            agg = counts
        elif kind == "mean":
            exact = _widen(v) if v.dtype in _INT32_TYPES else v  # uint32 as unsigned
            sums = _segment_reduce(exact.to(torch.float32), seg, live, "sum")
            agg = sums / torch.clamp(counts, min=1).to(torch.float32)
        else:
            agg = _segment_reduce(v, seg, live, kind)
        out[out_name] = zero_past_count(agg)
    return zero_past_count(group_keys), out, count


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
    """
    cfg = cfg or EngineConfig()
    for out_name, (col, kind) in aggs.items():
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind != "count" and col not in table.columns:
            raise KeyError(f"aggregation input column {col!r} not in table")

    ordered = sort_table(table, key, cfg, method)
    inputs = [
        (out_name, None if kind == "count" else ordered[col].data, kind)
        for out_name, (col, kind) in aggs.items()
    ]
    group_keys, out, count = aggregate_sorted_flat(ordered[key].data, table.length, inputs)
    n = table.length
    result: dict[str, Column] = {key: Column(group_keys, n)}
    for out_name, vals in out.items():
        result[out_name] = Column(vals, n)
    return Selection(Table(result), count)
