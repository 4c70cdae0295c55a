"""Distributed group-by aggregate and equi-join (BASELINE configs 4-5).

The PyTorch counterpart of ``gpuradixsort_tpu/parallel/dist_ops.py``.  Both
ride the range-partition exchange of ``dist_sort``: equal keys always land
on one shard, so the local operators (the segment reductions of
``ops.aggregate``, a sorted run-expansion join) give globally correct
results, and the shards' outputs concatenate in key order.

Per-shard outputs are fixed-capacity buffers with live counts and a global
``overflow`` flag; on overflow the exchange is retried with more slack, all
shards together.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_KEY, EngineConfig
from gpuradixsort_tpu_torch.core.table import int32_bits, round_up, uint32_as_int32, wide_keys
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.ops.aggregate import SUPPORTED, aggregate_sorted_flat
from gpuradixsort_tpu_torch.ops.filter import _compact_by_mask
from gpuradixsort_tpu_torch.ops.join import matches_exceed
from gpuradixsort_tpu_torch.parallel import mesh as M
from gpuradixsort_tpu_torch.parallel.dist_sort import (
    _capacity,
    _check_local,
    _live_mask,
    _resolve,
    _shard_exchange_sorted,
    all_counts,
)
from gpuradixsort_tpu_torch.utils.timing import StageClock

# The join's n_live: every exchanged row is live (its side's pads ride a flag).
_ALL_LIVE = 2**32 - 1


class ShardedGroups(NamedTuple):
    """This shard's groups; the global result is the live prefixes in shard order."""

    keys: torch.Tensor  # (num_shards * capacity,) uint32 group keys, ascending
    values: dict  # name -> (num_shards * capacity,) aggregated values
    counts: torch.Tensor  # (num_shards,) int32 groups of every shard
    overflow: torch.Tensor  # 0-d bool, the same on every shard


class ShardedJoin(NamedTuple):
    """This shard's joined rows; the global result is the live prefixes, key-ordered."""

    keys: torch.Tensor  # (join_cap,) uint32 matched keys
    probe_values: torch.Tensor  # (join_cap,)
    build_values: torch.Tensor  # (join_cap,)
    counts: torch.Tensor  # (num_shards,) int32 output rows of every shard
    overflow: torch.Tensor  # 0-d bool, exchange or join capacity exceeded


def _agg_shard_fn(keys, values: tuple, n_live: int, specs, cfg, mesh, capacity, bucket_bits,
                  method, clock):
    mkeys, midx, mvals, _, overflow = _shard_exchange_sorted(
        keys, values, n_live, cfg, mesh, capacity, bucket_bits, method, clock=clock)
    # Pad repair: compact live rows stably to the front, key order kept.
    compacted, live_count = _compact_by_mask(_live_mask(midx), [mkeys, *mvals], cfg)
    if clock:
        clock.mark("compaction")
    mkeys, mvals = compacted[0], compacted[1:]
    inputs = [(name, None if kind == "count" else mvals[vi], kind) for name, vi, kind in specs]
    gkeys, out, gcount = aggregate_sorted_flat(mkeys, live_count, inputs)
    if clock:
        clock.mark("aggregate")
    return gkeys, {name: out[name] for name, _, _ in specs}, gcount, overflow


def dist_group_by_aggregate(
    keys: torch.Tensor,
    values: Mapping[str, torch.Tensor],
    aggs: Mapping[str, tuple[str, str]],
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    method: str = "auto",
    n_live: int | None = None,
    auto_retry: bool = True,
    clock: StageClock | None = None,
) -> ShardedGroups:
    """Distributed group-by aggregation over the row mesh.

    ``keys``: this shard's (n_local,) uint32 rows (n_local a multiple of
    ``cfg.block``); ``values``: this shard's named payload columns;
    ``aggs`` maps output name -> (value name, kind), kind one of
    sum/count/min/max/mean.  Rows move so each group lands whole on one
    shard; ``gather_groups`` concatenates the shards in key order.
    """
    cfg = cfg or EngineConfig()
    method = _resolve(method)
    for out_name, (vname, kind) in aggs.items():
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind != "count" and vname not in values:
            raise KeyError(f"aggregation input {vname!r} not in values")
    p = mesh.num_shards
    n_local = keys.shape[0]
    _check_local("keys", n_local, mesh, cfg)
    n_live = n_local * p if n_live is None else n_live
    vnames = list(values.keys())
    varrs = tuple(values[v] for v in vnames)
    specs = tuple((out_name, vnames.index(vname) if kind != "count" else 0, kind)
                  for out_name, (vname, kind) in aggs.items())
    while True:
        if clock:
            clock.start()
        capacity = _capacity(n_local, cap_factor, p, cfg)
        gkeys, gvals, gcount, overflow = _agg_shard_fn(
            keys, varrs, n_live, specs, cfg, mesh, capacity, bucket_bits, method, clock)
        if not auto_retry or not bool(overflow) or capacity >= n_local:
            break
        cap_factor *= 2.0
    return ShardedGroups(gkeys, gvals, all_counts(mesh, gcount), overflow)


def gather_groups(result: ShardedGroups, mesh) -> tuple[np.ndarray, dict]:
    """The global (group keys, {name: values}) on the host of every shard."""
    if bool(result.overflow):
        raise RuntimeError(
            "distributed aggregate overflowed shard capacity; retry with "
            "larger cap_factor or more bucket_bits")
    counts = result.counts.cpu().numpy()
    return (M.gather_prefixes(mesh, result.keys, counts),
            {name: M.gather_prefixes(mesh, v, counts) for name, v in result.values.items()})


def _join_shard_fn(keys, side, live, payload, cfg, mesh, capacity, join_cap, bucket_bits,
                   method, clock):
    mkeys, _, (mside, mlive, mpay), _, overflow = _shard_exchange_sorted(
        keys, (side, live, payload), _ALL_LIVE, cfg, mesh, capacity, bucket_bits, method,
        clock=clock)
    # Split the key-sorted rows back into probe and build; stable compactions
    # keep each side key-sorted.
    (pk, pv), count_p = _compact_by_mask((mside == 0) & (mlive == 1), [mkeys, mpay], cfg)
    (bk, bv), count_b = _compact_by_mask((mside == 1) & (mlive == 1), [mkeys, mpay], cfg)
    if clock:
        clock.mark("compaction")
    total_rows = pk.shape[0]
    dev = pk.device
    pos = torch.arange(total_rows, device=dev)
    # Tails past the live counts are compaction leftovers: the pad key there.
    wpk = torch.where(pos < count_p, wide_keys(pk), PAD_KEY)
    wbk = torch.where(pos < count_b, wide_keys(bk), PAD_KEY)
    lo = torch.minimum(torch.searchsorted(wbk, wpk, side="left"), count_b)
    hi = torch.minimum(torch.searchsorted(wbk, wpk, side="right"), count_b)
    cnt = torch.where(pos < count_p, hi - lo, 0).to(torch.int32)
    offsets, total = exclusive_scan(cnt)  # K5 on a CUDA shard; int32, as the JAX package's
    cut = matches_exceed(cnt, join_cap) | overflow  # the int64 sum: the int32 total wraps
    overflow = M.all_reduce(mesh, cut.to(torch.int32).reshape(1), "max")[0] > 0

    slots = torch.arange(join_cap, device=dev)
    ends = offsets.to(torch.int64) + cnt
    prow = torch.searchsorted(ends, slots, side="right").clamp(0, total_rows - 1)
    ordinal = slots - offsets.to(torch.int64)[prow]
    brow = (lo[prow] + ordinal).clamp(0, total_rows - 1)
    n_out = total.clamp(max=join_cap)
    valid = slots < n_out

    def pick(col, rows, fill):
        bits = int32_bits(gather_columns([col], rows)[0])
        return torch.where(valid, bits, fill).view(col.dtype)

    out = (pick(pk, prow, uint32_as_int32(PAD_KEY)), pick(pv, prow, 0), pick(bv, brow, 0))
    if clock:
        clock.mark("probe")
    return out, n_out, overflow


def dist_join_inner(
    probe_keys: torch.Tensor,
    probe_values: torch.Tensor,
    build_keys: torch.Tensor,
    build_values: torch.Tensor,
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    join_cap_factor: float = 2.0,
    method: str = "auto",
    n_probe: int | None = None,
    n_build: int | None = None,
    auto_retry: bool = True,
    clock: StageClock | None = None,
) -> ShardedJoin:
    """Distributed inner equi-join with duplicate-key run expansion.

    Each shard passes its own slices of both sides (uint32 keys, one 4-byte
    payload column per side, both of one dtype).  Both sides go through ONE
    range-partition exchange, so equal keys of both sides meet on one
    shard; each shard then expands its sorted probe rows against its sorted
    build rows.  ``n_probe`` / ``n_build`` are the global live counts.
    Output rows are key-ordered across shards, the probe order kept within a
    key; sizes are fixed capacities with live counts and an overflow flag
    (retried with doubled slack).
    """
    cfg = cfg or EngineConfig()
    method = _resolve(method)
    p = mesh.num_shards
    np_local, nb_local = probe_keys.shape[0], build_keys.shape[0]
    _check_local("probe", np_local, mesh, cfg)
    _check_local("build", nb_local, mesh, cfg)
    if probe_values.dtype != build_values.dtype or probe_values.element_size() != 4:
        raise TypeError(
            f"payloads must share one 4-byte dtype, got {probe_values.dtype} and "
            f"{build_values.dtype}")
    n_probe = np_local * p if n_probe is None else n_probe
    n_build = nb_local * p if n_build is None else n_build
    dev = probe_keys.device
    # Shard s holds slice s of the probe, then slice s of the build: the JAX
    # package's shard-major interleave of the two concatenated sides.
    keys = torch.cat([int32_bits(probe_keys), int32_bits(build_keys)]).view(torch.uint32)
    side = torch.cat([torch.zeros(np_local, dtype=torch.int32, device=dev),
                      torch.ones(nb_local, dtype=torch.int32, device=dev)])
    first_p, first_b = mesh.shard * np_local, mesh.shard * nb_local
    live = torch.cat([torch.arange(first_p, first_p + np_local, device=dev) < n_probe,
                      torch.arange(first_b, first_b + nb_local, device=dev) < n_build]
                     ).to(torch.int32)
    payload = torch.cat([int32_bits(probe_values), int32_bits(build_values)]).view(
        probe_values.dtype)
    n_local = np_local + nb_local
    while True:
        if clock:
            clock.start()
        capacity = _capacity(n_local, cap_factor, p, cfg)
        join_cap = round_up(max(1, int(n_local * join_cap_factor)), cfg.block)
        (k, pv, bv), n_out, overflow = _join_shard_fn(
            keys, side, live, payload, cfg, mesh, capacity, join_cap,
            bucket_bits, method, clock)
        if not auto_retry or not bool(overflow) or join_cap_factor >= 64:
            break
        cap_factor *= 2.0
        join_cap_factor *= 2.0
    return ShardedJoin(k, pv, bv, all_counts(mesh, n_out), overflow)


def gather_join(result: ShardedJoin, mesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The global (keys, probe values, build values) on the host of every shard."""
    if bool(result.overflow):
        raise RuntimeError(
            "distributed join overflowed capacity; retry with larger "
            "cap_factor/join_cap_factor")
    counts = result.counts.cpu().numpy()
    return tuple(M.gather_prefixes(mesh, col, counts)
                 for col in (result.keys, result.probe_values, result.build_values))
