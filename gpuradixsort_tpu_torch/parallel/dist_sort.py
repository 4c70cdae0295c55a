"""Distributed stable sort: range-partition exchange + local radix sort.

The PyTorch counterpart of ``gpuradixsort_tpu/parallel/dist_sort.py``.  Each
rank of the row mesh sorts its shard locally with the radix method (K1, K5,
K4 on a CUDA shard), the shards agree on a bucket histogram of the observed
key range (``all_reduce``), buckets go whole to shards in balanced ranges,
the rows move in one ``all_to_all`` per column, and each shard merges the
sorted runs it received.  Equal keys always land on one shard, and each
source block arrives sorted, so a stable merge reproduces the global
original order among equal keys; pad sentinels that interleave with real
0xFFFFFFFF keys are moved behind them by one stable compaction on the pad
index (K1, K5, K4 again).

Two exchange schedules, as in the JAX package:

- the default: one tiled ``all_to_all`` per column, then a merge tree of
  the P received runs (P a power of two; otherwise the concatenation is
  re-sorted with the radix method);
- ``overlap=True``, the ring: P-1 steps of ``batch_isend_irecv``, each
  received block merged into an accumulator while the next step is in
  flight.

The JAX package differs in three places, each a defect the port does not
copy:

- its ``dist_sort_pairs`` never passes ``overlap`` on, so its ring cannot
  be reached; here it is passed on;
- its ring fold re-sorts the whole accumulator every step; here each step
  is one two-run merge on the composite (key, global index), which gives
  the same buffer;
- its bucket -> shard assignment multiplies int32 midpoints by P, which
  wraps once a midpoint times P reaches 2^31 (about 537M rows on 4 shards);
  here ``_shard_of_bucket`` computes in int64.

All counts, indices and the bucket arithmetic are int64 here; keys and the
global index column stay uint32 and move as int32 views.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort_tpu_torch.core.table import (
    int32_bits,
    round_up,
    uint32_as_int32,
    wide_keys,
    wrap_int32,
)
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.ops.filter import _compact_by_mask
from gpuradixsort_tpu_torch.ops.sort import _sort_padded
from gpuradixsort_tpu_torch.parallel import mesh as M
from gpuradixsort_tpu_torch.utils.timing import StageClock

METHODS = ("auto", "radix", "torch")


class ShardedSort(NamedTuple):
    """This shard's sorted run; the global result is the live prefixes in shard order."""

    keys: torch.Tensor  # (num_shards * capacity,) uint32, sorted
    index: torch.Tensor  # (num_shards * capacity,) uint32 original row ids
    counts: torch.Tensor  # (num_shards,) int32 live rows of every shard
    overflow: torch.Tensor  # 0-d bool, the same on every shard: retry with more slack


def _full_u32(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, uint32_as_int32(value), dtype=torch.int32, device=device).view(
        torch.uint32)


def _place(out_len: int, pos_a, pos_b, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[pos_a] = a and out[pos_b] = b along the last dim (positions disjoint)."""
    bits_a, bits_b = int32_bits(a), int32_bits(b)
    out = torch.empty(a.shape[:-1] + (out_len,), dtype=bits_a.dtype, device=a.device)
    out.scatter_(-1, pos_a, bits_a).scatter_(-1, pos_b, bits_b)
    return out.view(a.dtype)


def _merge_on(wa: torch.Tensor, wb: torch.Tensor, a_cols, b_cols) -> list[torch.Tensor]:
    """Merge two runs sorted on the int64 ``wa``/``wb``; a precedes b on ties.

    a[i] lands at i + #{b < a[i]} and b[j] at j + #{a <= b[j]}: disjoint
    positions covering every slot.  Leading dims are a batch of merges.
    """
    pos_a = torch.arange(wa.shape[-1], device=wa.device) + torch.searchsorted(wb, wa, side="left")
    pos_b = torch.arange(wb.shape[-1], device=wb.device) + torch.searchsorted(wa, wb, side="right")
    out_len = wa.shape[-1] + wb.shape[-1]
    return [_place(out_len, pos_a, pos_b, a, b) for a, b in zip(a_cols, b_cols)]


def _merge_pair(ak, bk, a_payloads, b_payloads):
    """Stably merge two sorted uint32 key runs (+ payloads); a precedes b on ties.

    Takes runs of any lengths, and leading batch dims.  Returns (keys,
    payloads) as the JAX package's ``_merge_pair`` does.
    """
    out = _merge_on(wide_keys(ak), wide_keys(bk), (ak, *a_payloads), (bk, *b_payloads))
    return out[0], tuple(out[1:])


def _merge_runs(keys2d: torch.Tensor, payloads2d: tuple):
    """Merge P sorted equal-length runs ((P, L) -> flat) in log2(P) levels.

    Each level merges all pairs at once.  Pad tails (key 0xFFFFFFFF) may
    interleave with real max keys of later sources; the caller's pad
    compaction repairs that.
    """
    p = keys2d.shape[0]
    if p & (p - 1):
        raise ValueError(f"merge tree needs power-of-two runs, got {p}")
    cols = [keys2d, *payloads2d]
    while p > 1:
        pairs = [c.reshape(p // 2, 2, -1) for c in cols]
        cols = _merge_on(wide_keys(pairs[0][:, 0]), wide_keys(pairs[0][:, 1]),
                         [c[:, 0] for c in pairs], [c[:, 1] for c in pairs])
        p //= 2
    return cols[0].reshape(-1), tuple(c.reshape(-1) for c in cols[1:])


def _shard_of_bucket(hist: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Balanced bucket -> shard map, in int64.

    Each bucket goes whole to the shard its midpoint row falls in:
    ``(cum_excl + hist // 2) * num_shards // total``, clipped to the shards.
    Monotone in the bucket, so ``searchsorted`` finds each shard's first
    bucket.  The JAX package computes this in int32, which wraps once a
    midpoint times ``num_shards`` reaches 2^31.
    """
    hist = hist.to(torch.int64)
    total = hist.sum().clamp(min=1)
    mid = torch.cumsum(hist, 0) - hist + hist // 2
    return ((mid * num_shards) // total).clamp(0, num_shards - 1)


def _composite(keys: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(key, gidx) as one int64 in the same order: the key's sign bit flipped, shifted up.

    Pads (PAD_KEY, PAD_INDEX) are the largest value, so they sort last.
    """
    hi = (int32_bits(keys) ^ torch.iinfo(torch.int32).min).to(torch.int64)
    return hi * (1 << 32) + wide_keys(gidx)


def _local_sort(keys, carried: tuple, cfg: EngineConfig, method: str):
    """Stable local sort of keys, carrying columns: the radix method or torch.sort."""
    if method == "radix":
        return _sort_padded(keys, carried, cfg)
    order = torch.sort(wide_keys(keys), stable=True).indices
    keys, *carried = gather_columns([keys, *carried], order)
    return keys, tuple(carried)


def _ring_merge_exchange(mesh, send_keys, send_payloads: tuple, send_counts, capacity: int):
    """The ring schedule: P-1 steps, merge-as-you-receive.

    ``send_keys`` / ``send_payloads[0]`` (the global index) / further
    payloads: (num_shards, capacity), row d = my rows for shard d.  Step s
    delivers to every shard the block from shard (me + s) % P; the next
    step is posted before this one's block is merged.  Every block and the
    accumulator are sorted on (key, gidx), which is a total order, so one
    two-run merge per step gives the fold's result whatever the arrival
    order.  Live rows after step s number at most (s+1) * capacity and pads
    sort last, so cutting the merge back to P * capacity drops only pads.
    """
    p = mesh.num_shards
    total = p * capacity
    dev = send_keys.device
    acc = [_full_u32((total,), PAD_KEY, dev), _full_u32((total,), PAD_INDEX, dev),
           *(torch.zeros(total, dtype=x.dtype, device=dev) for x in send_payloads[1:])]
    count = torch.zeros((), dtype=torch.int64, device=dev)

    def blocks(s):
        pick = (mesh.shard - s) % p
        return [send_keys[pick], *(x[pick] for x in send_payloads), send_counts[pick:pick + 1]]

    inflight = blocks(0)  # step 0: my own block, no transfer
    for s in range(p):
        nxt = M.RingStep(mesh, blocks(s + 1), s + 1) if s + 1 < p else None
        got = inflight if s == 0 else inflight.wait()
        *cols, blk_count = got
        merged = _merge_on(_composite(acc[0], acc[1]), _composite(cols[0], cols[1]), acc, cols)
        acc = [m[:total] for m in merged]
        count = count + blk_count[0]
        inflight = nxt
    return acc[0], tuple(acc[1:]), count


def _shard_exchange_sorted(keys, extras: tuple, n_live: int, cfg: EngineConfig, mesh,
                           capacity: int, bucket_bits: int, method: str,
                           overlap: bool = False, clock: StageClock | None = None):
    """The per-shard exchange core: local sort, partition, exchange, merge.

    Returns ``(mkeys, midx, merged_extras, count, overflow)``: this shard's
    key-sorted rows (num_shards * capacity of them), its live count (0-d
    int64) and the global overflow flag (0-d bool).  Pad sentinels may
    interleave with real 0xFFFFFFFF keys; callers repair that with the
    PAD_INDEX compaction.
    """
    p = mesh.num_shards
    n_local = keys.shape[0]
    dev = keys.device
    rows = torch.arange(n_local, dtype=torch.int64, device=dev)
    gidx64 = mesh.shard * n_local + rows
    gidx = wrap_int32(gidx64).view(torch.uint32)  # low 32 bits, as the JAX package's uint32
    # Tail pad rows (global index >= n_live) stay out of the exchange; after
    # the local sort they are an exact suffix (max key, largest indices).
    pad_count = (gidx64 >= n_live).sum()
    live_local = n_local - pad_count

    # 1. Local stable sort of (key, global index, extras).
    skeys, (sidx, *sextras) = _local_sort(keys, (gidx, *extras), cfg, method)
    if clock:
        clock.mark("local sort")

    # 2. Global bucket histogram over the observed live key range.
    num_buckets = 1 << bucket_bits
    wkeys = wide_keys(skeys)
    has_live = live_local > 0
    last = (live_local - 1).clamp(min=0)
    kmin_kmax = torch.stack([torch.where(has_live, wkeys[0], PAD_KEY),
                             torch.where(has_live, wkeys[last], 0)])
    kmin = M.all_reduce(mesh, kmin_kmax[:1], "min")[0]
    kmax = M.all_reduce(mesh, kmin_kmax[1:], "max")[0]
    span = kmax - torch.minimum(kmin, kmax)
    width = span // num_buckets + 1
    sbuckets = ((wkeys - kmin) // width).clamp(max=num_buckets - 1)
    edges = torch.arange(num_buckets + 1, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(sbuckets, edges, side="left")
    local_hist = bounds[1:] - bounds[:-1]
    local_hist[num_buckets - 1] -= pad_count  # the pad suffix sits in the last bucket
    hist = M.all_reduce(mesh, local_hist, "sum")

    # 3-4. Bucket -> shard map, and my sorted run split at shard boundaries.
    shard_of_bucket = _shard_of_bucket(hist, p)
    first_bucket = torch.searchsorted(
        shard_of_bucket, torch.arange(p, dtype=torch.int64, device=dev), side="left")
    lo = torch.searchsorted(sbuckets, first_bucket, side="left")
    hi = torch.cat([lo[1:], torch.full((1,), n_local, dtype=torch.int64, device=dev)])
    lo, hi = torch.minimum(lo, live_local), torch.minimum(hi, live_local)
    send_counts = hi - lo
    overflow = (send_counts > capacity).any().to(torch.int32).reshape(1)

    # 5. Fixed-capacity send blocks: a gather with tail fill.
    col = torch.arange(capacity, dtype=torch.int64, device=dev)
    src = (lo[:, None] + col[None, :]).clamp(0, n_local - 1)
    valid = col[None, :] < send_counts[:, None]

    def pack(arr, fill):
        taken = int32_bits(arr)[src]
        return torch.where(valid, taken, torch.tensor(fill, dtype=taken.dtype,
                                                      device=dev)).view(arr.dtype)

    send_keys = pack(skeys, uint32_as_int32(PAD_KEY))
    send_idx = pack(sidx, uint32_as_int32(PAD_INDEX))
    send_extras = tuple(pack(x, 0) for x in sextras)
    overflow_g = M.all_reduce(mesh, overflow, "max")[0] > 0

    if overlap:
        mkeys, (midx, *mextras), count = _ring_merge_exchange(
            mesh, send_keys, (send_idx, *send_extras), send_counts, capacity)
        if clock:
            clock.mark("ring exchange + merge")
        return mkeys, midx, tuple(mextras), count, overflow_g

    # 6. Exchange: one tiled all_to_all per column, source-major.
    recv = [M.all_to_all(mesh, x.reshape(-1)) for x in (send_keys, send_idx, *send_extras)]
    count = M.all_to_all(mesh, send_counts).sum()
    if clock:
        clock.mark("exchange")

    # 7. Merge the P received runs: a merge tree, or a re-sort for other P.
    if p & (p - 1) == 0:
        mkeys, (midx, *mextras) = _merge_runs(
            recv[0].reshape(p, capacity), tuple(x.reshape(p, capacity) for x in recv[1:]))
    else:
        mkeys, (midx, *mextras) = _local_sort(recv[0], tuple(recv[1:]), cfg, method)
    if clock:
        clock.mark("merge")
    return mkeys, midx, tuple(mextras), count, overflow_g


def _live_mask(midx: torch.Tensor) -> torch.Tensor:
    """1 where a merged row is live (its index is not PAD_INDEX)."""
    return (int32_bits(midx) != uint32_as_int32(PAD_INDEX)).to(torch.int32)


def _capacity(n_local: int, cap_factor: float, num_shards: int, cfg: EngineConfig) -> int:
    """Rows of one (source -> dest) block: n_local / P with ``cap_factor`` slack."""
    return round_up(max(1, int(n_local * cap_factor) // num_shards), cfg.block)


def _resolve(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    return "radix" if method == "auto" else method


def _check_local(name: str, n_local: int, mesh, cfg: EngineConfig) -> None:
    if n_local % cfg.block:
        raise ValueError(
            f"{name}: a shard of {n_local} rows is not a multiple of block={cfg.block} "
            f"(global length must be a multiple of num_shards*block="
            f"{mesh.num_shards * cfg.block}); pad first")


def all_counts(mesh, count: torch.Tensor) -> torch.Tensor:
    """(num_shards,) int32: every shard's count, in shard order."""
    return M.all_gather(mesh, count.reshape(1).to(torch.int32)).reshape(-1)


def dist_sort_pairs(
    keys: torch.Tensor,
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    method: str = "auto",
    n_live: int | None = None,
    auto_retry: bool = True,
    overlap: bool = False,
    clock: StageClock | None = None,
) -> ShardedSort:
    """Distributed stable sort of (key, original index) pairs over the row mesh.

    ``keys``: this shard's (n_local,) uint32 rows, n_local a multiple of
    ``cfg.block``; shard s holds global rows s*n_local .. (s+1)*n_local-1.
    ``n_live`` is the global live count (rows past it are pads).  Every
    shard calls this with the same arguments but its own keys.

    ``method``: ``"radix"`` (and ``"auto"``) is the kernel path;
    ``"torch"`` sorts locally with ``torch.sort``, the library baseline.
    On overflow the exchange is retried with doubled ``cap_factor`` until
    the capacity reaches a full shard; every shard reads the same reduced
    flag, so they retry together.  ``overlap=True`` takes the ring
    schedule.  ``clock`` records the stage times.
    """
    cfg = cfg or EngineConfig()
    method = _resolve(method)
    p = mesh.num_shards
    n_local = keys.shape[0]
    _check_local("keys", n_local, mesh, cfg)
    if not 1 <= bucket_bits <= 20:
        raise ValueError("bucket_bits must be in [1, 20]")
    n_live = n_local * p if n_live is None else n_live
    while True:
        if clock:
            clock.start()
        capacity = _capacity(n_local, cap_factor, p, cfg)
        mkeys, midx, _, count, overflow = _shard_exchange_sorted(
            keys, (), n_live, cfg, mesh, capacity, bucket_bits, method, overlap, clock)
        # Real max keys before pad sentinels.
        (mkeys, midx), _ = _compact_by_mask(_live_mask(midx), [mkeys, midx], cfg)
        if clock:
            clock.mark("compaction")
        capacity_full = int(cap_factor) >= p or capacity >= n_local
        if not auto_retry or not bool(overflow) or capacity_full:
            break
        cap_factor *= 2.0
    return ShardedSort(mkeys, midx, all_counts(mesh, count), overflow)


def gather_sorted(result: ShardedSort, mesh) -> tuple[np.ndarray, np.ndarray]:
    """The global sorted (keys, index) on the host of every shard.

    All-gathers the live prefixes; every shard must call it.
    """
    if bool(result.overflow):
        raise RuntimeError(
            "distributed sort overflowed shard capacity; retry with larger "
            "cap_factor or more bucket_bits")
    counts = result.counts.cpu().numpy()
    return (M.gather_prefixes(mesh, result.keys, counts),
            M.gather_prefixes(mesh, result.index, counts))
