"""A group-by's aggregates over a key-sorted buffer: ``segment_aggregate``.

The PyTorch counterpart of the aggregate step of
``gpuradixsort_tpu/ops/aggregate.py::aggregate_sorted_flat``: a segmented
prefix combine per aggregate (``jax.lax.associative_scan``), whose value at
each run end is its group's aggregate, then the compaction of the run ends
to the front (``_compact_by_mask``: the Pallas kernels K1 at radix 2 and K4,
and a scatter).  On a CUDA tensor ``segment_aggregate`` launches
``csrc/segment_agg.cu``, one pass that writes each group's aggregates once
at its slot, with no atomics; on a CPU tensor it runs the plain version,
``_segment_aggregate_ref``.

The group-by hands it the columns unsorted, with the sort's permutation
(``rows``): sorted row ``i`` of a column is ``col[rows[i]]``, clamped as
``ops/permute.py::gather_rows`` clamps it, so no sorted copy of a column is
written and read back.  The JAX package gathers first (``sort_table``) and
aggregates the gathered columns, which computes the same.

The plain version reduces each segment once (``index_add_`` /
``scatter_reduce_`` over segment ids from a cumsum of the run starts) into
slot ``segment id``, which is already the compacted order.  Integer sums are
taken in int64 and wrap to 32 bits, which is the int32 (or uint32) sum
modulo 2^32.  Float sums are taken in float64 and rounded to float32 once,
so they are at least as close to the exact sum as the JAX package's float32
tree.  ``mean`` is the float32 sum of the values cast to float32, divided by
the float32 count.  Float min and max propagate NaN, as ``jnp.minimum`` and
``jnp.maximum`` do.  The kernel computes the same; its float64 sums add in
another order, so a float sum or mean may differ from the plain version's by
one float32 ulp.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from gpuradixsort_tpu_torch.config import resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits, wrap_int32
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.ops.permute import gather_rows

SUPPORTED = ("sum", "count", "min", "max", "mean")

_INT32_TYPES = (torch.int32, torch.uint32)
_VALUE_TYPES = (torch.int32, torch.uint32, torch.float32)

# Launch geometry and limits of csrc/segment_agg.cu, which checks them again.
PARTITION = 8 * 512  # rows a block: 8 walking warps of 32 threads, 16 rows a thread
MAX_AGGREGATES = 8  # aggregates a launch (so also distinct columns); more run further launches

# The kernel's accumulators (csrc/segment_agg.cu's AccKind).
(SUM_U32, SUM_F32, SUM_I32_AS_F32, SUM_U32_AS_F32, MIN_I32, MAX_I32, MIN_U32, MAX_U32,
 MIN_F32, MAX_F32, COUNT) = range(11)
_ACC_OF = {
    ("sum", torch.int32): SUM_U32, ("sum", torch.uint32): SUM_U32,
    ("sum", torch.float32): SUM_F32,
    ("mean", torch.int32): SUM_I32_AS_F32, ("mean", torch.uint32): SUM_U32_AS_F32,
    ("mean", torch.float32): SUM_F32,
    ("min", torch.int32): MIN_I32, ("min", torch.uint32): MIN_U32,
    ("min", torch.float32): MIN_F32,
    ("max", torch.int32): MAX_I32, ("max", torch.uint32): MAX_U32,
    ("max", torch.float32): MAX_F32,
}


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
    else:
        wide = v.to(torch.float64) if kind == "sum" else v
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
    if v.dtype == torch.float32:
        # A NaN wins, as in jnp.minimum / jnp.maximum, whatever scatter_reduce_
        # does with it on this device.
        nans = torch.zeros(padded, dtype=torch.int32, device=v.device)
        nans.index_add_(0, seg, (torch.isnan(v) & live).to(torch.int32))
        acc = torch.where(nans > 0, float("nan"), acc)
    return _narrow(acc, v.dtype) if v.dtype in _INT32_TYPES else acc


def _segment_aggregate_ref(keys: torch.Tensor, n_live, inputs):
    """Plain version of ``segment_aggregate``: segment ids, then one reduction each."""
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


def _check_inputs(keys: torch.Tensor, inputs, rows: torch.Tensor | None) -> None:
    if keys.dtype != torch.uint32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous 1-D torch.uint32 tensor, got {keys.dtype} "
                         f"of shape {tuple(keys.shape)}")
    if rows is not None and (rows.dtype != torch.int32 or rows.shape != keys.shape
                             or rows.device != keys.device or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous torch.int32 tensor of the keys' "
                         f"{keys.numel()} rows on {keys.device}, got {rows.dtype} of shape "
                         f"{tuple(rows.shape)} on {rows.device}")
    for out_name, v, kind in inputs:
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind == "count":
            continue
        if v is None:
            raise ValueError(f"aggregation {out_name!r} ({kind}) needs a column")
        if v.dtype not in _VALUE_TYPES:
            raise TypeError(f"aggregation takes int32, uint32 or float32 columns, got {v.dtype}")
        if rows is None:
            if v.shape != keys.shape or v.device != keys.device or not v.is_contiguous():
                raise ValueError(f"column of {out_name!r} must be contiguous, of the keys' "
                                 f"{keys.numel()} rows on {keys.device}, got shape "
                                 f"{tuple(v.shape)} on {v.device}")
        elif v.dim() != 1 or v.numel() == 0 or v.device != keys.device or not v.is_contiguous():
            raise ValueError(f"column of {out_name!r} read through rows must be contiguous, 1-D, "
                             f"of at least one row, on {keys.device}, got shape "
                             f"{tuple(v.shape)} on {v.device}")


def launch_plan(inputs) -> list[dict]:
    """The kernel's launches for ``inputs``: their columns, accumulators and outputs.

    Up to ``MAX_AGGREGATES`` aggregates a launch, in order.  A launch reads
    each distinct column (the same tensor) once; ``count`` and each mean's
    count share one count accumulator, and a float32 column's sum and mean
    one float64 sum.  Each launch: ``columns`` (tensors), ``accs`` ((kind,
    column index or -1) pairs), ``outputs`` ((name, dtype, accumulator,
    count accumulator or -1) tuples).  The first launch also writes the
    group keys and the count.
    """
    plans = []
    for first in range(0, max(len(inputs), 1), MAX_AGGREGATES):
        columns: list[torch.Tensor] = []
        accs: list[tuple[int, int]] = []
        outputs = []

        def acc_index(kind: int, column: int) -> int:
            if (kind, column) not in accs:
                accs.append((kind, column))
            return accs.index((kind, column))

        for out_name, v, kind in inputs[first:first + MAX_AGGREGATES]:
            if kind == "count":
                outputs.append((out_name, torch.int32, acc_index(COUNT, -1), -1))
                continue
            col = next((i for i, c in enumerate(columns) if c is v), None)
            if col is None:
                columns.append(v)
                col = len(columns) - 1
            acc = acc_index(_ACC_OF[kind, v.dtype], col)
            if kind == "mean":
                outputs.append((out_name, torch.float32, acc, acc_index(COUNT, -1)))
            else:
                outputs.append((out_name, v.dtype, acc, -1))
        plans.append({"columns": columns, "accs": accs, "outputs": outputs})
    return plans


def scratch_words(padded: int, accumulators: int) -> int:
    """64-bit scratch words of a launch: a ticket, a status word and two payloads a partition."""
    parts = -(-padded // PARTITION)
    return 1 + parts * (1 + 2 * accumulators)


def segment_aggregate(
    keys: torch.Tensor,
    n_live,
    inputs: Sequence[tuple[str, torch.Tensor | None, str]],
    rows: torch.Tensor | None = None,
    impl: str | None = None,
):
    """Aggregate a key-sorted padded buffer per run of equal keys.

    ``keys``: (padded,) uint32 sorted ascending with live rows first;
    ``n_live``: an int or a 0-d integer tensor (on the card for the kernel,
    which reads it there, so no host sync).  ``inputs``: (out_name, values
    or None, kind) with kind one of ``SUPPORTED``; values are int32, uint32
    or float32, and None is only valid for "count".  Without ``rows`` each
    column has the keys' length and row ``i`` is its element ``i``.
    ``rows``: the sort's permutation, a contiguous int32 tensor of the keys'
    length on their device; sorted row ``i`` of a column is then
    ``col[rows[i]]``, ``rows[i]`` clamped to the column's own length (a pad
    row's -1 to row 0, as ``gather_rows`` and the JAX package's gather
    clamp); rows at or past ``n_live`` read neither ``rows`` nor a column.
    Returns ``(group_keys, {name: values}, count)``, compacted to the front,
    one row per group in key order, rows >= count zero; count is a 0-d
    int32 tensor.  sum, min and max keep the column's dtype, count is int32
    and mean float32.

    On the card, one launch of ``csrc/segment_agg.cu`` computes up to
    ``MAX_AGGREGATES`` aggregates; more run further launches, the group keys
    and the count written by the first.
    """
    inputs = list(inputs)
    _check_inputs(keys, inputs, rows)
    if resolve_impl(keys, impl) == "reference":
        if rows is not None:  # each distinct column gathered once
            gathered = {}
            for _, v, _ in inputs:
                if v is not None and id(v) not in gathered:
                    gathered[id(v)] = gather_rows(v, rows)
            inputs = [(name, None if v is None else gathered[id(v)], kind)
                      for name, v, kind in inputs]
        return _segment_aggregate_ref(keys, n_live, inputs)
    padded = keys.numel()
    dev = keys.device
    live_ptr, live_value = None, 0
    if isinstance(n_live, torch.Tensor):
        if n_live.dim() != 0 or n_live.dtype.is_floating_point or n_live.dtype == torch.bool:
            raise ValueError(f"n_live must be an int or a 0-d integer tensor, got "
                             f"{n_live.dtype} of shape {tuple(n_live.shape)}")
        if n_live.is_cuda:
            if n_live.device != dev:
                raise ValueError(f"n_live must be on the keys' device {dev}, not {n_live.device}")
            n_live = n_live.to(torch.int32)  # no sync: it stays on the card
            live_ptr = n_live.data_ptr()
        else:
            live_value = int(n_live)
    else:
        live_value = int(n_live)

    group_keys = torch.empty_like(keys)
    count = torch.empty((), dtype=torch.int32, device=dev)
    out: dict[str, torch.Tensor] = {}
    for i, plan in enumerate(launch_plan(inputs)):
        results = [(name, torch.empty(padded, dtype=dtype, device=dev), acc, cnt)
                   for name, dtype, acc, cnt in plan["outputs"]]
        words = [len(plan["columns"]), len(plan["accs"]), len(results)]
        words += [w for c in plan["columns"] for w in (c.data_ptr(), c.numel())]
        words += [w for acc in plan["accs"] for w in acc]
        words += [w for _, t, acc, cnt in results for w in (t.data_ptr(), acc, cnt)]
        spec = (ctypes.c_int64 * len(words))(*words)
        nwords = scratch_words(padded, len(plan["accs"]))
        scratch = torch.empty(nwords, dtype=torch.int64, device=dev)
        launch("grs_segment_aggregate", keys, keys.data_ptr(), padded, live_ptr, live_value,
               None if rows is None else rows.data_ptr(), ctypes.addressof(spec), len(words),
               group_keys.data_ptr() if i == 0 else None,
               count.data_ptr() if i == 0 else None, scratch.data_ptr(), nwords)
        segment_aggregate.launches += 1
        out.update((name, t) for name, t, _, _ in results)
    return group_keys, out, count


segment_aggregate.launches = 0
