"""Equi-join of columnar tables on uint32 keys: sort the build side, probe by search.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/join.py``.  The build side
is sorted by key once (the engine's stable radix sort); every probe row
finds its match by a search of the sorted build keys, and the result is
compacted by ``ops/filter.py``.

- ``join``: inner / semi / anti, build keys unique.  The probe is one
  ``join_probe`` (``kernels/probe.py``; on the card ``csrc/join_probe.cu``,
  one launch): the uint32 keys read as they lie, int32 positions (inner
  joins only) and the int32 keep mask written together.  Only the rows
  below the probe's length are searched: the rows past it are searched as
  PAD_KEY, where the JAX package searches whatever lies there, which is
  PAD_KEY in every probe ``make_key_column`` builds.  They are pads: their
  keep is 0, and their position that of PAD_KEY.
- ``join_expand``: inner join with duplicate build keys.  Each probe row
  matches a run of the sorted build keys (``torch.searchsorted`` of both
  sides widened to int64, which takes no uint32); the exclusive scan of
  the run lengths (K5 on a CUDA tensor) gives each probe row its first
  output slot, and the rows land in a buffer of fixed ``capacity`` with a
  live count.

Only ``validate_unique`` and ``to_table`` read a value back to the host,
each inside the span ``grs.join.sync``.  A call is the span ``grs.join``,
its phases ``grs.join.build`` (the build side's sort) and ``grs.join.probe``
(the searches and the gathers).  Each gather moves all its payload columns
through one index in one ``gather_columns``.  The probe's searches and
``join``'s gather of the build payloads count their rows (``trace.rows``);
``join``'s probe counts the rows it searches (the live rows rounded up to
the kernel's tile) and, as ``trace.probe_filled``, the pad rows it writes
unsearched.  ``join_expand``'s gathers do not count, since their live
count stays on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Column, Table, int32_bits, round_up, wide_keys
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.kernels.probe import join_probe, walked_rows
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.ops.filter import Selection, filter_table
from gpuradixsort_tpu_torch.ops.sort import sort_table
from gpuradixsort_tpu_torch.utils import trace

JOIN_TYPES = ("inner", "semi", "anti")

# The most output slots K5's int32 slot offsets can lay out.
MAX_SLOTS = 2**31 - 1


def matches_exceed(cnt: torch.Tensor, capacity: int) -> torch.Tensor:
    """0-d bool: do the per-row match counts ``cnt`` add up to more than ``capacity``?

    The sum is taken in int64, because the int32 total of their scan wraps
    at 2^31.  A capacity above ``MAX_SLOTS`` counts as ``MAX_SLOTS``: more
    matches than that cannot be laid out, and are reported as a cut.
    """
    return cnt.sum(dtype=torch.int64) > min(capacity, MAX_SLOTS)


def _zero_invalid(g: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rows of ``g`` where ``valid`` is False set to zero."""
    mask = valid.reshape((-1,) + (1,) * (g.dim() - 1))
    return torch.where(mask, int32_bits(g), 0).view(g.dtype)


def join(
    probe: Table,
    build: Table,
    key: str,
    how: str = "inner",
    cfg: EngineConfig | None = None,
    validate_unique: bool = False,
    build_prefix: str = "build_",
) -> Selection:
    """Join ``probe`` rows against ``build`` rows on uint32 column ``key``.

    - ``inner``: probe rows with a build match, plus the build payload
      columns (named ``build_<name>``).
    - ``semi``: probe rows with a build match, probe columns only.
    - ``anti``: probe rows without a build match.

    Build keys must be unique for ``inner``; ``validate_unique=True`` checks
    (a host sync).
    """
    cfg = cfg or EngineConfig()
    if how not in JOIN_TYPES:
        raise ValueError(f"unknown join type: {how}")

    with trace.span("grs.join"):
        with trace.span("grs.join.build"):
            build_sorted = sort_table(build, key, cfg)
        nb = build.length
        with trace.span("grs.join.probe"):
            bkeys = build_sorted[key].valid()  # sorted, uint32
            if validate_unique and nb > 1:
                bits = int32_bits(bkeys)
                with trace.span("grs.join.sync"):
                    duplicate = bool((bits[1:] == bits[:-1]).any())
                if duplicate:
                    raise ValueError(
                        "build side has duplicate keys; use join_expand for one-to-many joins"
                    )

            pcol = probe[key]
            walked = walked_rows(probe.length, pcol.padded_length)
            trace.rows("probe", probe.length, walked)
            trace.probe_filled(pcol.padded_length - walked)
            pos, keep = join_probe(pcol.data, probe.length, bkeys, positions=how == "inner",
                                   negate=how == "anti")

            if how == "inner":
                cols = dict(probe.columns)
                payloads = [name for name in build_sorted.names() if name != key]
                if payloads:
                    trace.rows("gather", probe.length, pos.numel())
                    gathered = gather_columns([build_sorted[name].data for name in payloads],
                                              pos)
                    cols.update((build_prefix + name, Column(g, probe.length))
                                for name, g in zip(payloads, gathered))
                joined = Table(cols)
            else:
                joined = probe
            del pos, bkeys, build_sorted  # not held through the compaction
        selection = filter_table(joined, lambda _t: keep, cfg)
        return dataclasses.replace(selection, op="grs.join")


@dataclasses.dataclass(frozen=True)
class ExpandedJoin:
    """One-to-many join result: padded rows, live count, overflow flag.

    ``table`` holds ``capacity`` rows; rows >= ``count`` are zero.  If
    ``overflow`` is True the matches outnumber the capacity and the output
    was cut: retry with a larger ``capacity``.
    """

    table: Table
    count: torch.Tensor  # 0-d int32: number of matches
    overflow: torch.Tensor  # 0-d bool

    def to_table(self) -> Table:
        with trace.span("grs.join.sync"):
            overflow, n = bool(self.overflow), int(self.count)
        if overflow:
            raise RuntimeError(
                "join_expand output exceeded capacity; retry with a larger capacity"
            )
        return Table({name: Column(col.data, n) for name, col in self.table.columns.items()})


def join_expand(
    probe: Table,
    build: Table,
    key: str,
    cfg: EngineConfig | None = None,
    capacity: int | None = None,
    build_prefix: str = "build_",
) -> ExpandedJoin:
    """Inner join that allows duplicate build keys.

    Output rows are (probe row, build row) pairs ordered by probe row, then
    by build order within the key's run.  ``capacity`` (rounded up to a
    block) defaults to the probe's padded length, enough when each probe
    row matches at most once.  ``overflow`` is True whenever the matches
    outnumber the capacity, however many there are; a capacity of 2^31 or
    more is capped at ``MAX_SLOTS`` matches (``matches_exceed``).  ``count``
    is the int32 total of the slot scan: the number of matches whenever
    ``overflow`` is False.
    """
    cfg = cfg or EngineConfig()
    with trace.span("grs.join"):
        with trace.span("grs.join.build"):
            build_sorted = sort_table(build, key, cfg)
        nb = build.length
        with trace.span("grs.join.probe"):
            bkeys = wide_keys(build_sorted[key].valid())

            pkeys = wide_keys(probe[key].data)
            padded = probe[key].padded_length
            dev = pkeys.device
            live = torch.arange(padded, device=dev) < probe.length

            trace.rows("probe", 2 * probe.length, 2 * padded)  # two searches
            lo = torch.searchsorted(bkeys, pkeys, side="left").to(torch.int32)
            hi = torch.searchsorted(bkeys, pkeys, side="right").to(torch.int32)
            cnt = torch.where(live, hi - lo, 0)
            offsets, total = exclusive_scan(cnt)  # first output slot of each probe row

            capacity = round_up(padded if capacity is None else capacity, cfg.block)
            overflow = matches_exceed(cnt, capacity)

            # Slot j belongs to the probe row whose slot range holds j; its ordinal
            # in that range picks the build row from the run.
            slots = torch.arange(capacity, device=dev)
            ends = (offsets + cnt).to(torch.int64)
            prow = torch.searchsorted(ends, slots, side="right").clamp(0, padded - 1)
            brow = lo.to(torch.int64)[prow] + slots - offsets.to(torch.int64)[prow]
            valid = slots < total.clamp(max=capacity)
            safe_brow = brow.clamp(0, max(nb - 1, 0))

            payloads = [name for name in build_sorted.names() if name != key]
            gathered = (gather_columns([probe[name].data for name in probe.names()], prow)
                        + gather_columns([build_sorted[name].data for name in payloads],
                                         safe_brow))
            names = probe.names() + [build_prefix + name for name in payloads]
            cols = {name: Column(_zero_invalid(g, valid), capacity)
                    for name, g in zip(names, gathered)}
        return ExpandedJoin(Table(cols), total, overflow)
