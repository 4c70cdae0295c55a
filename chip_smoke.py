#!/usr/bin/env python3
"""Smoke gate of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``gpuradixsort_tpu_torch/csrc`` into
``build/kernels/`` (nvcc, sm_90a, one process per source, all at once), then
in eight phases:

1. device: PyTorch version, the card's name and power limit, build time;
2. each kernel against its plain PyTorch version on the card, exact
   equality: radix_hist and radix_dest at radix_bits 1, 2, 4, 8; bucketize
   at 1, 2, 4; scatter_runs on the plain-bucketized input; bucketize_scatter
   (the table pass: K2 then K3 in one kernel, reading K1's offsets table) and
   bucketize_scatter_lookback (the fused sort's pass: its run offsets by
   look-back from sort_plan's digit bases) at 1, 2, 4; each at shifts 0, 4
   and 28, on 4 blocks of random keys and on 1,000,000 keys padded, with
   sort_plan (the key read with every pass's digit counts and bases) on the
   same; radix_hist and bucketize also at tile_rows 1, 3, 8 and 16, on
   tile counts that leave the last block part-filled and on keys 4 bytes
   off a 16-byte boundary, and radix_hist on 64-row tiles of equal keys;
   bucketize_scatter at tile_rows 1, 3, 8 and 16, on 1, 8 and 29 tiles
   (and, radix 16, more tiles than the card holds warps at once), inputs
   also 4 bytes off, and with moved offsets whose out-of-range destinations
   are dropped; bucketize_scatter_lookback at the same geometries and at
   lengths that leave its last 4,096-key partition ragged, on more
   partitions than the card holds blocks at once, on random, skewed (one
   key holding 99%), equal and PAD_KEY keys, first and last pass; radix_dest
   at radix 2-256 (also those EngineConfig cannot name), at tile_rows 1, 3,
   8 and 16, on 1, 8 and 29 tiles and on keys 4 bytes off; dest_scatter (K4
   and the indexed stores after it) at radix_bits 1, 2, 4 and 8 on the same
   keys moving the keys and their index, and at radix 2-256, tile_rows 1,
   3, 8, 16 and 64, on 1, 8 and 29 tiles, moving 0, 1, 8 and 9 columns of
   1- to 16-byte rows (2-D among them; 9 take two launches), rank keys also
   4 bytes off; scatter_runs at
   radix 2, 4, 16, 32, 64 and 256, tile_rows 1, 3, 8 and 16, on 1 and 9
   tiles and (radix 16) on more tiles than the card holds warps at once,
   inputs also 4 bytes off, and with moved offsets; exclusive_scan at
   lengths 1, 4,095-4,097, its chunk and one either side, two chunks and
   one, 1,000,000, 2^24 and 100,000,000, each also one word off a 16-byte
   boundary, on values whose sums wrap; key_bits (the AND and OR of the
   keys) at lengths 0 to 2^24, aligned and one word off, also against
   numpy; sort_plan at radix_bits 1, 2 and 4 on 0 keys to 2^24, random,
   skewed, equal and PAD_KEY keys, aligned and one word off, its counts
   also against numpy; the fused sort's pass plan, and radix_hist,
   bucketize_scatter and bucketize_scatter_lookback routed by it (the last
   by sort_plan's), pass by pass (every route: the input into R or S, R
   into S, S into R), for every mask of 4-bit digits over 8 passes on 4
   blocks and four masks at 1M keys (radix_hist, bucketize, scatter_runs,
   bucketize_scatter, bucketize_scatter_lookback, radix_dest and dest_scatter
   are also held against their plain versions at the operator path's shapes, after
   phase 4: 2^24 keys at radix_bits 1, 4 and 8, the filter's 100,000,000
   keys at radix_bits 1, 4 and 8, and its 1-bit compaction input; key_bits
   and sort_plan, its counts also against numpy, on the 100M buffers the
   fused sorts of phase 6 reduce and the 2^24 keys); and the fused sort's
   live route: sort_args (the argument block) against its plain words,
   sort_plan at a live length and the look-back pass from the input with
   its rows past the length read as pads and the index made or given,
   pass by pass as the plan routes them, against their plain versions, at
   radix_bits 1, 2 and 4 on 4 blocks and at radix 16 on 3,173 partitions,
   at live lengths inside the last (ragged) partition, in earlier ones and
   at the ends, the rows past the length stale;
3. the main path through the public entry points on CUDA tensors:
   ``sort_pairs`` of 1,000,000 shuffled 0..N-1 keys (sorted keys == arange, permutation == numpy's stable
   argsort), of 2^20 shuffled keys (where the constant-digit skip fires), of
   2^24 random keys with duplicates, and ``sort_table`` of 1,000,000 rows of a
   key and 16 int32 payload columns (64-byte rows), every column checked;
   each pair sort by the fused and the radix method, each sort three times
   (the first sighting of its shape eager, the second capturing its CUDA
   graph, the third replaying it) under torch's sync debug mode, which must
   count no host sync at the first sighting and at the replay; the fused
   sorts' skipped passes read from the card's counter between the calls;
   also ``sort_pairs`` of a 2^21-row key column whose 1,000,000 live rows
   are followed by stale keys, which the fused sort reads as pads; each
   method's sorts one window, with every launch count set to 0 before and
   read after it: the fused sorts must launch sort_args and sort_plan once
   a sort and bucketize_scatter_lookback once a pass, and K1, K5,
   bucketize_scatter, key_bits, bucketize and scatter_runs never; the
   radix sorts K1, K5 and dest_scatter once a pass each, and K4 and none of
   the fused sort's never;
4. the operator path, counts again set to 0 before and read after, every
   result checked exactly against numpy (float means within rtol 1e-5 of a
   float64 oracle): ``filter_table`` of 100,000,000 keys keeping about half,
   then ``sort_keys`` of the survivors; ``group_by_aggregate`` of
   100,000,000 rows over 1,000,000 keys (sum, count, min, max, mean);
   ``join`` inner, semi and anti of a 100,000,000-row skewed probe against
   10,000,000 unique build keys; ``join_expand`` of a 10,000,000-row probe
   against about two copies of each build key; ``sort_pairs`` by the radix
   method at 1M and 2^24 keys and ``sort_keys`` with 8-bit digits;
5. times: the fused sort's passes as the cached CUDA graph against the
   eager loop at 1M, 2^22, 2^23, 12M, 2^24 and 2^25 keys, and the radix
   method's at 1M, 2^22, 2^23, 12M and 2^24, in alternating rounds (CUDA
   events and busy time, the first call's capture time, the bytes the graph
   cache holds;
   the profile of a replay must name every kernel of the method, the fused
   sort's profiles must hold no device work but its kernels and memsets,
   and at 2^24 the fused sort's device time outside the port's kernels is
   split by profiler row); the fused sort by look-back against the same
   sort with the table pass (K1, global_offsets, bucketize_scatter, with
   the index column and re-padding by torch and a graph that copies, as
   the fused sort ran before its argument block) and the torch method at
   1M, 2^24 and 2^26 random keys, each by its own graph cache, in
   alternating rounds (CUDA events over the bench's chain of sorts, and
   busy time split by kernel, at 2^24 and 2^26 also the look-back sort's
   device time outside the port's kernels by row); fused sort against
   ``torch.sort(stable=True)`` at 1M and 16M keys (CUDA events, median of
   7 runs after warm-up, and the device's busy time from torch.profiler);
   each kernel of one pass at 1M and 16M beside its plain version (device
   time from the profiler, and CUDA-event time per call), its bound (the
   bytes it must move at 3.35 TB/s) and its share of that bound, and
   exclusive_scan and global_offsets beside ``torch.cumsum``; the 1M x 64
   B table sort; at radix 2, 16 and 256 on (key, index) pairs, dest_scatter
   beside K4 then scatter_by_destination (the stores it replaces), K4 alone
   and K1, in alternating turns; key_bits, sort_plan
   (random, skewed and equal keys), exclusive_scan beside ``torch.cumsum``
   on a vector, and the look-back pass, the table pass whole, bucketize_scatter,
   bucketize and scatter_runs on a radix-16 pass, at 1M, 2^24 and
   100,000,000 keys, each with its bound and share of bound;
6. times of the operator path: each operator and the radix sort beside the
   fused sort, by CUDA events (median of 3) with the profiler's busy share;
7. the distributed path, counts set to 0 before each timed op in every
   rank and read after it: 4 gloo ranks on this one card (NCCL refuses two
   ranks on one GPU), every collective staged through pinned host memory,
   run ``dist_sort_pairs`` of phase 4's 100,000,000 keys by the all_to_all
   schedule and by the ring, ``dist_group_by_aggregate`` of the 100M-row x
   1M-key table and ``dist_join_inner`` of the 100M probe against the 10M
   build; then one NCCL rank runs ``dist_sort_pairs`` at 2^24 keys and
   ``dist_join_inner`` of the join_expand inputs.  Each op runs once
   untimed, then timed (wall after synchronize and a barrier, split by
   stage on every rank); every result is checked exactly against numpy,
   and K1, K5 and dest_scatter must have launched on every rank, K4 never;
8. the bench, ``python -m gpuradixsort_tpu_torch.bench --sizes 1000000``,
   in a child process: every method checked and timed at 1M keys, the
   per-stage table and the table sort; it must exit 0, and its JSON line
   (logged, never the last line) and its table must name this card.
   Phase 5's bytes per kernel are the bench's ``stage_work``.

Exits non-zero at the first failure, including when no CUDA device is
present or a kernel of a path's launch count stayed 0.  Before it exits, pass or
fail, it stops every process it started.  The line before the last is
the card's name and power limit; the last line is the JSON result.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import types
import warnings
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import resource_tracker
from unittest import mock

import numpy as np
import torch

from gpuradixsort_tpu_torch.bench import DURATIONS_FILE, chain_for, stage_work
from gpuradixsort_tpu_torch.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort_tpu_torch.core.table import (
    Column,
    Table,
    int32_bits,
    make_column,
    make_key_column,
    pad_to_tile,
    round_up,
)
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels.bucketize import _bucketize_ref, bucketize_tiles
from gpuradixsort_tpu_torch.kernels.key_bits import (
    ARGS_WORDS,
    LOOKBACK_PARTITION,
    SortArgs,
    key_bits,
    live_input,
    pass_mask,
    pass_plan,
    plan_of_mask,
    sort_args,
    sort_plan,
)
from gpuradixsort_tpu_torch.kernels import scan as scan_kernels
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.kernels.scatter import (
    bucketize_scatter,
    bucketize_scatter_lookback,
    scatter_runs,
)
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.aggregate import group_by_aggregate
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.join import join, join_expand
from gpuradixsort_tpu_torch.ops.permute import scatter_by_destination
from gpuradixsort_tpu_torch.ops.sort import sort_keys, sort_pairs, sort_table
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils.timing import (
    HBM_PEAK_TBS,
    StageTimes,
    bound_of,
    card_line,
    median_per_call_ms,
    per_call_ms,
    profiled_device_ms,
)
from gpuradixsort_tpu_torch.utils.verify import (
    device_is_sorted,
    is_permutation_sorted,
    join_oracle,
    mask_keys,
)

SEED = 20170101
N_HEADLINE = 1_000_000
PAYLOAD_COLS = 16

# name: (wrapper, source, TPU kernel it replaces, its __global__ functions)
KERNELS = {
    # The fused sort's argument block: its input, live length and result on
    # the card, which stand for the JAX package's index column and re-padding.
    "sort_args": (sort_args, "gpuradixsort_tpu_torch/csrc/key_bits.cu",
                  "gpuradixsort_tpu/ops/sort.py:193 and gpuradixsort_tpu/ops/sort.py:246",
                  ("sort_args_kernel",)),
    # The fused sort's key read: the plan and every pass's digit counts and
    # bases, which the JAX package sums from K1 in every pass.
    "sort_plan": (sort_plan, "gpuradixsort_tpu_torch/csrc/key_bits.cu",
                  "gpuradixsort_tpu/ops/sort.py:81 and gpuradixsort_tpu/ops/sort.py:83",
                  ("sort_plan_kernel",)),
    # The fused sort's pass: K1, the offsets, K2 and K3 in one kernel, its
    # run offsets by look-back.
    "bucketize_scatter_lookback": (
        bucketize_scatter_lookback, "gpuradixsort_tpu_torch/csrc/bucketize_scatter.cu",
        "gpuradixsort_tpu/kernels/radix.py:57, gpuradixsort_tpu/kernels/bucketize.py:156 and "
        "gpuradixsort_tpu/kernels/scatter.py:107",
        ("lookback_scatter_kernel",)),
    "radix_hist": (rk.tile_histograms, "gpuradixsort_tpu_torch/csrc/radix_hist.cu",
                   "gpuradixsort_tpu/kernels/radix.py:57", ("radix_hist_kernel",)),
    "bucketize": (bucketize_tiles, "gpuradixsort_tpu_torch/csrc/bucketize.cu",
                  "gpuradixsort_tpu/kernels/bucketize.py:156",
                  ("bucketize_1k_kernel", "bucketize_any_kernel")),
    "scatter_runs": (scatter_runs, "gpuradixsort_tpu_torch/csrc/scatter_runs.cu",
                     "gpuradixsort_tpu/kernels/scatter.py:107",
                     ("scatter_1k_kernel", "scatter_any_kernel")),
    # The table pass: K2 then K3 in one kernel, its run offsets from K1's table.
    "bucketize_scatter": (bucketize_scatter, "gpuradixsort_tpu_torch/csrc/bucketize_scatter.cu",
                          "gpuradixsort_tpu/kernels/bucketize.py:156 and "
                          "gpuradixsort_tpu/kernels/scatter.py:107",
                          ("bucketize_scatter_1k_kernel", "bucketize_scatter_any_kernel")),
    "radix_dest": (rk.tile_destinations, "gpuradixsort_tpu_torch/csrc/radix_dest.cu",
                   "gpuradixsort_tpu/kernels/radix.py:92", ("radix_dest_kernel",)),
    # K4 and the indexed stores after it: the radix pass and the compaction
    # place their own rows.
    "dest_scatter": (rk.dest_scatter, "gpuradixsort_tpu_torch/csrc/radix_dest.cu",
                     "gpuradixsort_tpu/kernels/radix.py:92 and gpuradixsort_tpu/ops/permute.py:34",
                     ("dest_scatter_kernel",)),
    "exclusive_scan": (exclusive_scan, "gpuradixsort_tpu_torch/csrc/scan.cu",
                       "gpuradixsort_tpu/kernels/scan.py:31", ("scan_kernel",)),
    # Glue with no Pallas kernel: the JAX package's per-pass skip predicate,
    # and the plan made from it, without the digit counts.
    "key_bits": (key_bits, "gpuradixsort_tpu_torch/csrc/key_bits.cu",
                 "gpuradixsort_tpu/ops/sort.py:83", ("key_bits_kernel", "pass_plan_kernel")),
}
# The kernels each sort method runs.  A fused sort writes its argument block,
# reads its keys once in sort_plan and runs the look-back pass in every pass;
# K1, K5, the table pass, the plain key_bits, K2 and K3 run on none of its
# path.  A radix pass runs K1, K5 and dest_scatter; K4 runs on no path.
FUSED_PATH = ("sort_args", "sort_plan", "bucketize_scatter_lookback")
RADIX_PATH = ("radix_hist", "dest_scatter", "exclusive_scan")
OFF_FUSED = tuple(name for name in KERNELS if name not in FUSED_PATH)
OFF_PATH = ("bucketize", "scatter_runs", "bucketize_scatter", "key_bits", "radix_dest")


def reset_launches() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        log(f"FAIL  {what}")
        raise SmokeFailure(what)
    log(f"PASS  {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over two integer tensors of one shape, as unsigned."""
    if a.shape != b.shape:
        raise SmokeFailure(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    wide = [int32_bits(t).to(torch.int64) for t in (a, b)]
    if a.dtype == torch.uint32:
        wide = [w & 0xFFFFFFFF for w in wide]
    return int((wide[0] - wide[1]).abs().max()) if a.numel() else 0


def iota_index(n: int, cfg: EngineConfig, device) -> torch.Tensor:
    """0..n-1 as uint32, padded with PAD_INDEX as the sort pads its index."""
    iota = torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    return pad_to_tile(iota, cfg, PAD_INDEX)


def phase_kernels(dev, rng, errs: dict) -> None:
    """Phase 2: each kernel against its plain version, exact equality."""
    for label, n in (("4 blocks", 4 * EngineConfig().block), ("1M padded", N_HEADLINE)):
        keys_np = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        for bits in (1, 2, 4, 8):
            cfg = EngineConfig(radix_bits=bits)
            keys = make_key_column(keys_np, cfg, device=dev).data
            idx = iota_index(n, cfg, dev)
            if cfg.radix <= 16:
                check_sort_plan(keys, cfg, errs, f"{label} radix_bits={bits}")
            for shift in (0, 4, 28):
                where = f"{label} radix_bits={bits} shift={shift}"
                hist_ref = rk.tile_histograms(keys, shift, cfg, impl="reference")
                err = max_abs_err(rk.tile_histograms(keys, shift, cfg, impl="cuda"), hist_ref)
                errs["radix_hist"] = max(errs["radix_hist"], err)
                check(err == 0, f"radix_hist == plain, {where}")
                offsets = rk.global_offsets(hist_ref)
                dest_ref = rk.tile_destinations(keys, offsets, shift, cfg, impl="reference")
                err = max_abs_err(rk.tile_destinations(keys, offsets, shift, cfg, impl="cuda"),
                                  dest_ref)
                errs["radix_dest"] = max(errs["radix_dest"], err)
                check(err == 0, f"radix_dest == plain, {where}")
                err = max_dest_scatter_err(keys, hist_ref, offsets, shift, cfg, [keys, idx])
                errs["dest_scatter"] = max(errs["dest_scatter"], err)
                check(err == 0, f"dest_scatter == plain (keys and index), {where}")
                if cfg.radix > 16:
                    continue
                bk_ref, bi_ref = _bucketize_ref(keys, idx, shift, cfg)
                bk, bi = bucketize_tiles(keys, idx, shift, cfg, impl="cuda")
                err = max(max_abs_err(bk, bk_ref), max_abs_err(bi, bi_ref))
                errs["bucketize"] = max(errs["bucketize"], err)
                check(err == 0, f"bucketize == plain, {where}")
                ok_ref, oi_ref, _ = scatter_runs(bk_ref, bi_ref, hist_ref, offsets, cfg,
                                                 impl="reference")
                ok, oi, overflow = scatter_runs(bk_ref, bi_ref, hist_ref, offsets, cfg,
                                                impl="cuda")
                err = max(max_abs_err(ok, ok_ref), max_abs_err(oi, oi_ref))
                errs["scatter_runs"] = max(errs["scatter_runs"], err)
                check(err == 0 and not overflow, f"scatter_runs == plain, {where}")
                got = bucketize_scatter(keys, idx, hist_ref, offsets, shift, cfg, impl="cuda")
                err = max(max_abs_err(got[0], ok_ref), max_abs_err(got[1], oi_ref))
                errs["bucketize_scatter"] = max(errs["bucketize_scatter"], err)
                check(err == 0, f"bucketize_scatter == plain, {where}")
                state = sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64, device=dev))
                got = bucketize_scatter_lookback(keys, idx, cfg, state, shift // bits)
                err = max(max_abs_err(got[0], ok_ref), max_abs_err(got[1], oi_ref))
                errs["bucketize_scatter_lookback"] = max(errs["bucketize_scatter_lookback"], err)
                check(err == 0, f"bucketize_scatter_lookback == plain, {where}")
    check_hist_bucketize_geometry(dev, rng, errs)
    check_fused_geometry(dev, rng, errs)
    check_lookback_geometry(dev, rng, errs)
    check_dest_geometry(dev, rng, errs)
    check_dest_scatter_geometry(dev, rng, errs)
    check_scatter_geometry(dev, rng, errs)
    check_scan_lengths(dev, rng, errs)
    check_key_bits(dev, rng, errs)
    check_plan_routing(dev, errs)
    check_live_route(dev, rng, errs)
    torch.cuda.synchronize()


def check_plan_routing(dev, errs: dict) -> None:
    """The fused sort's pass plan, and K1 and bucketize_scatter routed by it, against their plain versions.

    Every mask of 4-bit digits over the 8 passes on 4 blocks of keys whose
    digit p varies exactly where bit p is set, and the masks none, all, the
    top two constant and one pass on 1,007,616 keys (1M rounded up to a
    block, no pad keys).  The plan (key_bits with a plan) against the plain
    one and ``plan_of_mask``, the skip counters equal; then in each pass of
    the kernels' sort, K1 (where the pass runs) and bucketize_scatter
    against their plain versions on the same inputs and plan, the fused pass
    on copies of the result R and scratch S (every route: the input into R
    or S, R into S, S into R; a skipped pass writing nothing); the sorted
    pairs in R against a stable ``torch.sort``, and the input unwritten.
    """
    cfg = EngineConfig()
    cases = [(4 * cfg.block, m) for m in range(1 << cfg.num_passes)]
    cases += [(round_up(N_HEADLINE, cfg.block), m) for m in (0, 0xFF, 0x3F, 0b10000)]
    routes = set()
    for n, mask in cases:
        keys = torch.from_numpy(
            mask_keys(mask, n, cfg, np.random.default_rng([SEED, mask]))).to(dev)
        held = keys.clone()
        idx = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
        counters = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2)]
        plan = pass_plan(keys, cfg, counters[0], impl="cuda")
        want_plan = plan_of_mask(mask, cfg.num_passes)
        err = max(max_abs_err(plan, pass_plan(keys, cfg, counters[1], impl="reference")),
                  max_abs_err(plan.cpu(), torch.tensor(want_plan, dtype=torch.int32)),
                  max_abs_err(*counters))
        errs["key_bits"] = max(errs["key_bits"], err)
        where = f"{n} keys, pass mask {mask:#04x}"
        if err:
            check(False, f"pass plan == plain == plan_of_mask, {where}")
        state = sort_plan(keys, cfg, counters[0], impl="cuda")
        ref_state = sort_plan(keys, cfg, counters[1], impl="reference")
        err = max(max(map(max_abs_err, state[:3], ref_state[:3])), max_abs_err(*counters))
        errs["sort_plan"] = max(errs["sort_plan"], err)
        if err:
            check(False, f"sort_plan == plain, {where}")
        check_lookback_routes(keys, idx, cfg, (state, ref_state), errs, where)
        buffers = tuple((torch.empty_like(keys), torch.empty_like(idx)) for _ in range(2))
        for p in range(cfg.num_passes):
            shift, route = p * cfg.radix_bits, dict(plan=plan, pass_index=p, buffers=buffers)
            runs = want_plan[p] >= 0
            routes.add(rk.planned_route(torch.tensor(want_plan), p, ("input", "R", "S")))
            hist = rk.tile_histograms(keys, shift, cfg, impl="cuda", **route)
            if runs:
                err = max_abs_err(hist, rk.tile_histograms(keys, shift, cfg, impl="reference",
                                                           **route))
                errs["radix_hist"] = max(errs["radix_hist"], err)
                if err:
                    check(False, f"radix_hist with the plan == plain, {where}, pass {p}")
            offsets = rk.global_offsets(hist)
            want = tuple(tuple(t.clone() for t in pair) for pair in buffers)
            bucketize_scatter(keys, idx, hist, offsets, shift, cfg, impl="reference", plan=plan,
                              pass_index=p, buffers=want)
            bucketize_scatter(keys, idx, hist, offsets, shift, cfg, impl="cuda", **route)
            err = max(max_abs_err(g, w) for got, w_pair in zip(buffers, want)
                      for g, w in zip(got, w_pair))
            errs["bucketize_scatter"] = max(errs["bucketize_scatter"], err)
            if err:
                check(False, f"bucketize_scatter with the plan == plain, {where}, pass {p}")
        order = torch.sort(int32_bits(keys).to(torch.int64) & 0xFFFFFFFF, stable=True).indices
        if not (same_bits(buffers[0], (int32_bits(keys)[order], int32_bits(idx)[order]))
                and same_bits((keys,), (held,))):
            check(False, f"the planned passes sort stably into R and leave the input unwritten, "
                  f"{where}")
    check(routes >= {None, ("input", "R"), ("input", "S"), ("R", "S"), ("S", "R")},
          f"the plans routed passes {sorted(map(str, routes))}")
    check(True, f"pass plan, sort_plan's plan, counts and bases, and radix_hist, "
          f"bucketize_scatter and bucketize_scatter_lookback routed by the plan == their plain "
          f"versions pass by pass, and the sorted pairs in R == a stable torch.sort, for all "
          f"{1 << cfg.num_passes} masks of 4-bit digits on {4 * cfg.block} keys and 4 masks on "
          f"{round_up(N_HEADLINE, cfg.block)} keys")


def check_lookback_routes(keys, idx, cfg, states, errs: dict, where: str) -> None:
    """bucketize_scatter_lookback routed by a sort_plan, pass by pass, against its plain version.

    ``states``: the kernel's sort_plan of ``keys`` and the plain one.  Each
    pass writes copies of one pair of R and S buffers, the kernel's and the
    plain version's; then R against a stable ``torch.sort``.
    """
    state, ref_state = states
    buffers = tuple((torch.empty_like(keys), torch.empty_like(idx)) for _ in range(2))
    for p in range(cfg.num_passes):
        want = tuple(tuple(t.clone() for t in pair) for pair in buffers)
        bucketize_scatter_lookback(keys, idx, cfg, ref_state, p, want, impl="reference")
        bucketize_scatter_lookback(keys, idx, cfg, state, p, buffers, impl="cuda")
        err = max(max_abs_err(g, w) for got, w_pair in zip(buffers, want)
                  for g, w in zip(got, w_pair))
        errs["bucketize_scatter_lookback"] = max(errs["bucketize_scatter_lookback"], err)
        if err:
            check(False, f"bucketize_scatter_lookback with the plan == plain, {where}, pass {p}")
    order = torch.sort(int32_bits(keys).to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    if not same_bits(buffers[0], (int32_bits(keys)[order], int32_bits(idx)[order])):
        check(False, f"the look-back passes sort stably into R, {where}")


def numpy_digit_counts(keys: np.ndarray, cfg) -> np.ndarray:
    """Every pass's digit counts by numpy: a bincount of each 16-bit half, then one per digit."""
    out = np.zeros((cfg.num_passes, cfg.radix), dtype=np.int64)
    values = np.arange(1 << 16, dtype=np.uint32)
    for half in (0, 1):
        hist = np.bincount((keys >> np.uint32(16 * half)) & np.uint32(0xFFFF), minlength=1 << 16)
        for p in range(cfg.num_passes):
            shift = p * cfg.radix_bits - 16 * half
            if 0 <= shift < 16:
                digits = (values >> np.uint32(shift)) & np.uint32(cfg.radix - 1)
                out[p] = np.bincount(digits, weights=hist, minlength=cfg.radix).astype(np.int64)
    return out


def check_sort_plan(keys: torch.Tensor, cfg, errs: dict, where: str, host=None,
                    length=None) -> None:
    """sort_plan's plan, counts and bases at a live ``length`` (all keys by default)
    against its plain version; with ``host`` (the re-padded keys on the host) its counts
    also against numpy."""
    counters = [torch.zeros(1, dtype=torch.int64, device=keys.device) for _ in range(2)]
    got = sort_plan(keys, cfg, counters[0], impl="cuda", length=length)
    want = sort_plan(keys, cfg, counters[1], impl="reference", length=length)
    err = max(*map(max_abs_err, got[:3], want[:3]), max_abs_err(*counters))
    if host is not None:
        err = max(err, max_abs_err(got.counts.cpu(),
                                   torch.from_numpy(numpy_digit_counts(host, cfg)).to(torch.int32)))
    if got.lookback.any():
        err = max(err, 1)
    errs["sort_plan"] = max(errs["sort_plan"], err)
    numpy = " == numpy" if host is not None else ""
    check(err == 0, f"sort_plan (plan, counts, bases) == plain{numpy}, look-back scratch clear, "
          f"{where}")


def keys_of_kind(rng, n: int, kind: str) -> np.ndarray:
    """n keys of one kind: random, skewed (one key, so one digit of every pass, holding
    99%), equal, or all PAD_KEY."""
    if kind == "random":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "skewed":
        return np.where(rng.random(n) < 0.99, np.uint32(0x5A5A5A5A),
                        rng.integers(0, 2**32, n, dtype=np.uint32)).astype(np.uint32)
    return np.full(n, PAD_KEY if kind == "all PAD_KEY" else 0xDEADBEEF, dtype=np.uint32)


def check_key_bits(dev, rng, errs: dict) -> None:
    """key_bits against its plain version and numpy's bitwise reductions.

    Lengths 0, 1, 3, 127, 4,097, 1,000,000 and 2^24, each aligned and one
    word off a 16-byte boundary (a head and a tail of single keys); random
    keys, and at 1M keys that share all bits but one, and all PAD_KEY.
    """
    cases = [(n, off, "random") for n in (0, 1, 3, 127, 4097, N_HEADLINE, 1 << 24)
             for off in (0, 1)]
    cases += [(N_HEADLINE, 1, "one varying bit"), (N_HEADLINE, 0, "all PAD_KEY")]
    for n, off, kind in cases:
        if kind == "all PAD_KEY":
            buf = np.full(n + off, PAD_KEY, dtype=np.uint32)
        else:
            buf = rng.integers(0, 2**32, n + off, dtype=np.uint32)
            if kind == "one varying bit":
                buf = np.uint32(0x5A5A0000) | (buf & np.uint32(1 << 7))
        keys = torch.from_numpy(buf).to(dev)[off:]
        got = key_bits(keys, impl="cuda")
        err = max_abs_err(got, key_bits(keys, impl="reference"))
        want = (np.bitwise_and.reduce(buf[off:]) if n else np.uint32(PAD_KEY),
                np.bitwise_or.reduce(buf[off:]) if n else np.uint32(0))
        err = max(err, max_abs_err(got.cpu(), torch.from_numpy(np.array(want, dtype=np.uint32))))
        errs["key_bits"] = max(errs["key_bits"], err)
        check(err == 0, f"key_bits == plain == numpy, length {n}, {kind}, "
              f"{keys.data_ptr() % 16} bytes off a 16-byte boundary")
    for bits in (1, 2, 4):
        cfg = EngineConfig(radix_bits=bits)
        for n in (0, cfg.tile, 3 * cfg.block, round_up(N_HEADLINE, cfg.block), 1 << 24):
            for kind in ("random", "skewed", "equal", "all PAD_KEY"):
                if bits != 4 and n == 1 << 24 and kind != "random":
                    continue
                buf = keys_of_kind(rng, n + 1, kind)
                dbuf = torch.from_numpy(buf).to(dev)
                for off in (0, 1):
                    keys = dbuf[off:off + n]
                    check_sort_plan(keys, cfg, errs, f"radix_bits={bits}, length {n}, {kind}, "
                                    f"{keys.data_ptr() % 16} bytes off a 16-byte boundary",
                                    host=buf[off:off + n])


def stale_keys(rng, n: int) -> np.ndarray:
    """n random keys, 5% of them PAD_KEY: past a live length they stand for stale rows."""
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[rng.random(n) < 0.05] = np.uint32(PAD_KEY)
    return keys


def check_live_sort(keys, idx, length: int, cfg, errs: dict, where: str) -> None:
    """One fused sort's kernels on its live route against their plain versions.

    The argument block of (keys, idx, R, length) against its plain words;
    sort_plan at the length (plan, counts, bases, skipped passes); every
    look-back pass as the plan routes it, reading the input's rows past the
    length as pads and making the index where ``idx`` is None, on copies of
    R and S; R against a stable torch.sort of the re-padded input.
    """
    pairs = tuple((torch.zeros_like(keys), torch.zeros_like(keys)) for _ in range(2))
    args = SortArgs(keys, idx, pairs[0], length)
    block = sort_args(args)
    err = max_abs_err(block.cpu(), sort_args(args, impl="reference").cpu())
    errs["sort_args"] = max(errs["sort_args"], err)
    if err:
        check(False, f"sort_args == plain, {where}")
    counters = [torch.zeros(1, dtype=torch.int64, device=keys.device) for _ in range(2)]
    state = sort_plan(keys, cfg, counters[0], length=length, block=block)
    ref = sort_plan(keys, cfg, counters[1], impl="reference", length=length)
    err = max(*map(max_abs_err, state[:3], ref[:3]), max_abs_err(*counters))
    errs["sort_plan"] = max(errs["sort_plan"], err)
    if err:
        check(False, f"sort_plan at a live length == plain, {where}")
    for p in range(cfg.num_passes):
        want = tuple(tuple(t.clone() for t in pair) for pair in pairs)
        bucketize_scatter_lookback(keys, idx, cfg, state, p, pairs, length=length, block=block)
        bucketize_scatter_lookback(keys, idx, cfg, ref, p, want, impl="reference", length=length)
        err = max(max_abs_err(g, w) for got, w_pair in zip(pairs, want)
                  for g, w in zip(got, w_pair))
        errs["bucketize_scatter_lookback"] = max(errs["bucketize_scatter_lookback"], err)
        if err:
            check(False, f"bucketize_scatter_lookback at a live length == plain, {where}, "
                  f"pass {p}")
    live_keys, live_idx = live_input(keys, idx, length)
    order = torch.sort(int32_bits(live_keys).to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    if not same_bits(pairs[0], (int32_bits(live_keys)[order], int32_bits(live_idx)[order])):
        check(False, f"the live route's passes sort the re-padded input stably into R, {where}")


def check_live_route(dev, rng, errs: dict) -> None:
    """The fused sort's kernels on the live route (``check_live_sort``) at ragged lengths.

    4 blocks at radix_bits 1, 2 and 4, live lengths 0, 1, a tile less one,
    one partition of 4,096 keys, one inside the fourth partition, one inside
    the last and all; at radix 16 MANY_PARTITIONS partitions, the last
    ragged, live lengths inside the first, an earlier and the last
    partition and all.  The rows past each length hold stale keys (5%
    PAD_KEY, as the live ones); the index made, and given as a permutation.
    """
    part = LOOKBACK_PARTITION
    cases = []
    for bits in (1, 2, 4):
        cfg = EngineConfig(radix_bits=bits)
        n = 4 * cfg.block
        cases += [(cfg, n, length) for length in (0, 1, cfg.tile - 1, part, 3 * part + 17,
                                                  n - 5, n)]
    cfg = EngineConfig()
    n = MANY_PARTITIONS * part - 3 * cfg.tile  # the last partition holds 1,024 keys
    cases += [(cfg, n, length) for length in (1000, n - part - 100, n - 5, n)]
    for cfg, n, length in cases:
        keys = torch.from_numpy(stale_keys(rng, n)).to(dev)
        perm = torch.from_numpy(rng.permutation(n).astype(np.uint32)).to(dev)
        for idx in (None, perm):
            check_live_sort(keys, idx, length, cfg, errs,
                            f"radix_bits={cfg.radix_bits}, {n} keys, {length} live, index "
                            f"{'made' if idx is None else 'given'}")
        del keys, perm
    check(True, f"sort_args, sort_plan and bucketize_scatter_lookback on the live route == "
          f"their plain versions at radix_bits 1, 2, 4 on {4 * EngineConfig().block} keys and "
          f"radix 16 on {MANY_PARTITIONS} partitions, {len(cases)} live lengths, stale rows, "
          f"index made and given; R sorted")
    torch.cuda.empty_cache()


# More tiles than 64 warps on each of the H100's 132 SMs hold at once, the
# last block of 8 part-filled.
MANY_TILES = 64 * 132 + 37


def scatter_input(keys: torch.Tensor, shift: int, cfg):
    """scatter_runs' input from ``keys``: each tile stably sorted by digit by
    the plain bucketize (a per-tile argsort, which takes any radix), its
    histograms and offsets."""
    idx = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device).view(torch.uint32)
    hist = rk.tile_histograms(keys, shift, cfg, impl="reference")
    bk, bi = _bucketize_ref(keys, idx, shift, cfg)
    return bk, bi, hist, rk.global_offsets(hist)


def one_word_off(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def check_scatter_geometry(dev, rng, errs: dict) -> None:
    """scatter_runs against its plain version at every launch geometry.

    Radix 2, 4 and 16 (registers on the 1,024-key tile) and 32, 64 and 256
    (a warp's shared row), tile_rows 1, 3, 8 and 16, on 1 and 9 tiles (the
    last block of 8 part-filled) and at radix 16 on MANY_TILES, with inputs
    aligned and one word off a 16-byte boundary; then offsets moved by -5, 7
    and -3,083 rows (an inconsistent pair), whose destinations outside the
    buffer are dropped as the plain version drops them (the rows some slot
    lands on compared: the kernel leaves the others unwritten, the plain
    version zero).
    """
    def held(got, want, rows=slice(None)) -> None:
        errs["scatter_runs"] = max(errs["scatter_runs"], int(got[2] is not False),
                                   *(max_abs_err(g[rows], w[rows])
                                     for g, w in zip(got[:2], want[:2])))

    for tile_rows in (1, 3, 8, 16):
        for bits in (1, 2, 4, 5, 6, 8):
            cfg = any_radix_cfg(1 << bits, tile_rows)
            for num_tiles in (1, 9) + ((MANY_TILES,) if bits == 4 else ()):
                n = num_tiles * cfg.tile
                keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
                for shift in (0, 28):
                    bk, bi, hist, off = scatter_input(keys, shift, cfg)
                    want = scatter_runs(bk, bi, hist, off, cfg, impl="reference")
                    held(scatter_runs(bk, bi, hist, off, cfg, impl="cuda"), want)
                    held(scatter_runs(one_word_off(bk), one_word_off(bi), hist, off, cfg,
                                      impl="cuda"), want)
            if tile_rows in (1, 8):
                n = 5 * cfg.tile
                keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)
                bk, bi, hist, off = scatter_input(keys, 4, cfg)
                for shift_by in (-5, 7, -(3 * 1024 + 11)):
                    moved = off + shift_by
                    k = min(abs(shift_by), n)
                    held(scatter_runs(bk, bi, hist, moved, cfg, impl="cuda"),
                         scatter_runs(bk, bi, hist, moved, cfg, impl="reference"),
                         slice(k, n) if shift_by > 0 else slice(0, n - k))
    check(errs["scatter_runs"] == 0,
          "scatter_runs (radix 2, 4, 16, 32, 64, 256) == plain at tile_rows 1, 3, 8, 16, "
          f"1/9/{MANY_TILES} tiles, aligned and unaligned inputs; out-of-range destinations "
          "of moved offsets dropped")
    torch.cuda.empty_cache()


def check_scan_lengths(dev, rng, errs: dict) -> None:
    """exclusive_scan against its plain version at the lengths where its routes change.

    1, around 4,096 (the three-launch design's chunk), around one chunk
    (where the kernel starts to take tickets and look back), two chunks and
    one, then 1M, 2^24 and 100M; values over the whole int32 range, so that
    the sums wrap; each length also as a view one word off a 16-byte
    boundary, where the kernel loads 4 bytes at a time; and 1M values at the
    int32 limit and 1M small ones.
    """
    limit = np.iinfo(np.int32)
    chunk = scan_kernels.CHUNK
    lengths = (1, 4095, 4096, 4097, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
               N_HEADLINE, 1 << 24, N_OPS)
    cases = [(n, off) for n in lengths for off in (0, 1)]
    cases += [(N_HEADLINE, "max"), (N_HEADLINE, "small")]
    for n, off in cases:
        if off == "max":
            buf = torch.full((n,), limit.max, dtype=torch.int32, device=dev)
        elif off == "small":
            buf = torch.from_numpy(rng.integers(0, 100, n, dtype=np.int32)).to(dev)
        else:
            buf = torch.randint(limit.min, limit.max, (n + off,), dtype=torch.int32,
                                generator=torch.Generator(dev).manual_seed(n + off), device=dev)
        x = buf[1:] if off == 1 else buf
        scan, total = exclusive_scan(x, impl="cuda")
        scan_ref, total_ref = exclusive_scan(x, impl="reference")
        err = max(max_abs_err(scan, scan_ref), max_abs_err(total, total_ref))
        errs["exclusive_scan"] = max(errs["exclusive_scan"], err)
        wraps = int(x.to(torch.int64).sum()) != int(total_ref)
        check(err == 0, f"exclusive_scan == plain, length {n}, "
              f"{x.data_ptr() % 16} bytes off a 16-byte boundary, values "
              f"{int(x.min())}..{int(x.max())}{' (sums wrap)' if wraps else ''}")
        del buf, x, scan, scan_ref
    torch.cuda.empty_cache()


def any_radix_cfg(radix: int, tile_rows: int) -> types.SimpleNamespace:
    """A kernel geometry of any power-of-two radix, also those EngineConfig cannot name."""
    return types.SimpleNamespace(radix=radix, tile=tile_rows * 128, tile_rows=tile_rows)


def check_dest_geometry(dev, rng, errs: dict) -> None:
    """radix_dest against its plain version at every launch geometry.

    Radix 2-256 (registers up to 32, a warp's shared table above), tile_rows
    1, 3, 8 and 16, 1, 8 and 29 tiles (the last block of 8 part-filled), and
    keys 4 bytes off a 16-byte boundary.
    """
    for tile_rows in (1, 3, 8, 16):
        for bits in range(1, 9):
            cfg = any_radix_cfg(1 << bits, tile_rows)
            for num_tiles in (1, 8, 29):
                n = num_tiles * cfg.tile
                buf = torch.from_numpy(rng.integers(0, 2**32, n + 1, dtype=np.uint32)).to(dev)
                for keys in (buf[:n], buf[1:]):
                    for shift in (0, 28):
                        offsets = rk.global_offsets(
                            rk.tile_histograms(keys, shift, cfg, impl="reference"))
                        errs["radix_dest"] = max(errs["radix_dest"], max_abs_err(
                            rk.tile_destinations(keys, offsets, shift, cfg, impl="cuda"),
                            rk.tile_destinations(keys, offsets, shift, cfg, impl="reference")))
    check(errs["radix_dest"] == 0,
          "radix_dest (radix 2-256) == plain at tile_rows 1, 3, 8, 16, 1/8/29 tiles, "
          "aligned and unaligned keys")


def max_dest_scatter_err(keys, hist, offsets, shift, cfg, columns) -> int:
    """The largest difference of dest_scatter's moves from the plain ones, bit patterns
    compared as words or bytes."""
    want = rk.dest_scatter(keys, hist, offsets, shift, cfg, columns, impl="reference")
    got = rk.dest_scatter(keys, hist, offsets, shift, cfg, columns, impl="cuda")
    if len(got) != len(want):
        raise SmokeFailure(f"dest_scatter returned {len(got)} columns, not {len(want)}")
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise SmokeFailure(f"dest_scatter returned {g.dtype} {tuple(g.shape)}, not "
                               f"{w.dtype} {tuple(w.shape)}")
        # Bits compared as 4-byte words where the elements are, else as bytes.
        as_bits = torch.int32 if g.element_size() == 4 else torch.uint8
        err = max(err, max_abs_err(g.reshape(-1).view(as_bits), w.reshape(-1).view(as_bits)))
    return err


def moved_columns(rng, n: int, count: int, dev) -> list:
    """``count`` columns of n rows, cycling through the layouts dest_scatter moves: 4-byte
    words, 2-D rows of 16 bytes and of three words, 2-, 1- and 8-byte elements."""
    makers = (
        lambda: rng.integers(0, 2**32, n, dtype=np.uint32),
        lambda: rng.integers(-(2**31), 2**31, (n, 4)).astype(np.int32),
        lambda: rng.standard_normal(n).astype(np.float32),
        lambda: rng.integers(-(2**31), 2**31, (n, 3)).astype(np.int32),
        lambda: rng.integers(-(2**15), 2**15, n).astype(np.int16),
        lambda: rng.integers(0, 2, n).astype(bool),
        lambda: rng.integers(-(2**62), 2**62, n, dtype=np.int64),
        lambda: rng.integers(-(2**15), 2**15, (n, 3)).astype(np.int16),
        lambda: rng.standard_normal((n, 2)).astype(np.float32),
    )
    return [torch.from_numpy(makers[i % len(makers)]()).to(dev) for i in range(count)]


def check_dest_scatter_geometry(dev, rng, errs: dict) -> None:
    """dest_scatter against its plain version at every launch geometry.

    Radix 2-256 (registers up to 32, a warp's shared tables above), tile_rows
    1, 3, 8, 16 and 64 (staging past 48 KB a block, opted in), 1, 8 and 29
    tiles (the last block of 4 part-filled), 0, 1, 8 and 9 moved columns
    (9: two launches) of every layout, 2-D rows among them, rank keys
    aligned and 4 bytes off a 16-byte boundary.
    """
    for tile_rows in (1, 3, 8, 16, 64):
        for bits in range(1, 9):
            cfg = any_radix_cfg(1 << bits, tile_rows)
            for num_tiles in (1, 8, 29):
                n = num_tiles * cfg.tile
                buf = torch.from_numpy(rng.integers(0, 2**32, n + 1, dtype=np.uint32)).to(dev)
                for keys, shift in ((buf[:n], 0), (buf[1:], 28)):
                    hist = rk.tile_histograms(keys, shift, cfg, impl="reference")
                    offsets = rk.global_offsets(hist)
                    for count in (0, 1, 8, 9):
                        columns = moved_columns(rng, n, count, dev)
                        errs["dest_scatter"] = max(errs["dest_scatter"], max_dest_scatter_err(
                            keys, hist, offsets, shift, cfg, columns))
    check(errs["dest_scatter"] == 0,
          "dest_scatter (radix 2-256) == plain at tile_rows 1, 3, 8, 16, 64, 1/8/29 tiles, "
          "0/1/8/9 columns of 1- to 16-byte rows, aligned and unaligned keys")


def check_hist_bucketize_geometry(dev, rng, errs: dict) -> None:
    """radix_hist and bucketize against their plain versions at every launch geometry.

    tile_rows 1, 3, 8 and 16 at every radix; 1, 8 and 29 tiles, so that the
    last block of 4 or 8 tiles is part-filled; and the same keys 4 bytes off
    a 16-byte boundary, where radix_hist loads 4 bytes at a time.  Then
    radix_hist on 64-row tiles of equal keys: 256 keys a lane fill one of
    its 8-bit fields as fast as keys can.
    """
    for bits in (4, 8):
        cfg = EngineConfig(radix_bits=bits, tile_rows=64)
        keys = torch.from_numpy(np.full(3 * cfg.tile, 0xA5A5A5A5, dtype=np.uint32)).to(dev)
        for shift in (0, 28):
            errs["radix_hist"] = max(errs["radix_hist"], max_abs_err(
                rk.tile_histograms(keys, shift, cfg, impl="cuda"),
                rk.tile_histograms(keys, shift, cfg, impl="reference")))
    for tile_rows in (1, 3, 8, 16):
        for bits in (1, 2, 4, 8):
            cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
            for num_tiles in (1, 8, 29):
                n = num_tiles * cfg.tile
                buf = torch.from_numpy(rng.integers(0, 2**32, n + 1, dtype=np.uint32)).to(dev)
                idx = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
                for keys in (buf[:n], buf[1:]):
                    for shift in (0, 28):
                        hist = rk.tile_histograms(keys, shift, cfg, impl="cuda")
                        errs["radix_hist"] = max(errs["radix_hist"], max_abs_err(
                            hist, rk.tile_histograms(keys, shift, cfg, impl="reference")))
                        if cfg.radix > 16:
                            continue
                        got = bucketize_tiles(keys, idx, shift, cfg, impl="cuda")
                        ref = _bucketize_ref(keys, idx, shift, cfg)
                        errs["bucketize"] = max(errs["bucketize"], *map(max_abs_err, got, ref))
    check(errs["radix_hist"] == 0 and errs["bucketize"] == 0,
          "radix_hist (radix 2-256) and bucketize (radix 2-16) == plain at tile_rows 1, 3, 8, "
          "16, 1/8/29 tiles, aligned and unaligned keys; radix_hist on 64-row tiles of "
          "equal keys")


def check_fused_geometry(dev, rng, errs: dict) -> None:
    """bucketize_scatter against its plain version at every launch geometry.

    Radix 2, 4 and 16 at tile_rows 1, 3, 8 and 16 (the register route on
    the 1,024-key tile, the staged rows on any other); 1, 8 and 29 tiles,
    so that the last block of 8 is part-filled, and at radix 16 MANY_TILES;
    inputs aligned and one word off a 16-byte boundary; shifts 0 and 28;
    and offsets moved by 7 and -5 rows, whose destinations outside the
    buffer are dropped (the rows some slot lands on compared).
    """
    for tile_rows in (1, 3, 8, 16):
        for bits in (1, 2, 4):
            cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
            for num_tiles in (1, 8, 29) + ((MANY_TILES,) if bits == 4 else ()):
                n = num_tiles * cfg.tile
                buf = torch.from_numpy(rng.integers(0, 2**32, n + 1, dtype=np.uint32)).to(dev)
                pos = torch.from_numpy(rng.permutation(n + 1).astype(np.uint32)).to(dev)
                for keys, idx in ((buf[:n], pos[:n]), (buf[1:], pos[1:])):
                    for shift in (0, 28):
                        hist = rk.tile_histograms(keys, shift, cfg, impl="reference")
                        off = rk.global_offsets(hist)
                        want = bucketize_scatter(keys, idx, hist, off, shift, cfg,
                                                 impl="reference")
                        got = bucketize_scatter(keys, idx, hist, off, shift, cfg, impl="cuda")
                        errs["bucketize_scatter"] = max(errs["bucketize_scatter"],
                                                        *map(max_abs_err, got, want))
                    for moved_by in (7, -5):
                        rows = slice(moved_by, n) if moved_by > 0 else slice(0, n + moved_by)
                        got, want = (bucketize_scatter(keys, idx, hist, off + moved_by, shift,
                                                       cfg, impl=impl) for impl in ("cuda",
                                                                                    "reference"))
                        errs["bucketize_scatter"] = max(errs["bucketize_scatter"], *(
                            max_abs_err(g[rows], w[rows]) for g, w in zip(got, want)))
    check(errs["bucketize_scatter"] == 0,
          "bucketize_scatter (radix 2, 4, 16) == plain at tile_rows 1, 3, 8, 16, "
          f"1/8/29/{MANY_TILES} tiles, aligned and unaligned inputs; out-of-range destinations "
          "of moved offsets dropped")
    torch.cuda.empty_cache()


# Partitions of the look-back pass (4,096 keys a block of 256 threads):
# more than the card holds at once, so that partitions wait on partitions
# of an earlier wave of blocks.
MANY_PARTITIONS = 8 * 132 * 3 + 5


def check_lookback_geometry(dev, rng, errs: dict) -> None:
    """bucketize_scatter_lookback against its plain version at every launch geometry.

    Radix 2, 4 and 16 at tile_rows 1, 3, 8 and 16; 1, 8 and 29 tiles, and
    lengths that leave a ragged last partition of 4,096 keys (at tile_rows
    1, 3, 8 and 16 a count of tiles that is no multiple of a partition's);
    at radix 16 also MANY_TILES, and at tile_rows 3 and 8 MANY_PARTITIONS
    partitions and a ragged one more, so that partitions look back across
    waves of blocks; random and skewed (one key holding 99%) keys, and on
    the shorter lengths also equal and PAD_KEY keys; inputs aligned and
    one word off a 16-byte boundary; the first and the last pass, each from
    a fresh sort_plan (a pass index serves one launch), unplanned.
    """
    skipped = torch.zeros(1, dtype=torch.int64, device=dev)
    part = LOOKBACK_PARTITION
    for tile_rows in (1, 3, 8, 16):
        for bits in (1, 2, 4):
            cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
            ragged = (3 * part + 5 * cfg.tile) // cfg.tile  # 3 partitions and a part
            lengths = (1, 8, 29, ragged)
            if bits == 4:
                lengths += (MANY_TILES,)
            if bits == 4 and tile_rows in (3, 8):  # several waves, the last partition ragged
                lengths += (MANY_PARTITIONS * part // cfg.tile + 1,)
            for num_tiles in lengths:
                n = num_tiles * cfg.tile
                pos = torch.from_numpy(rng.permutation(n + 1).astype(np.uint32)).to(dev)
                kinds = ("random", "skewed") if num_tiles >= MANY_TILES else (
                    "random", "skewed", "equal", "all PAD_KEY")
                for kind in kinds:
                    buf = torch.from_numpy(keys_of_kind(rng, n + 1, kind)).to(dev)
                    for keys, idx in ((buf[:n], pos[:n]), (buf[1:], pos[1:])):
                        for p in (0, cfg.num_passes - 1):
                            state = sort_plan(keys, cfg, skipped)
                            got = bucketize_scatter_lookback(keys, idx, cfg, state, p,
                                                             impl="cuda")
                            want = bucketize_scatter_lookback(keys, idx, cfg, state, p,
                                                              impl="reference")
                            err = max(map(max_abs_err, got, want))
                            errs["bucketize_scatter_lookback"] = max(
                                errs["bucketize_scatter_lookback"], err)
                            if err:
                                check(False, f"bucketize_scatter_lookback == plain, radix "
                                      f"{cfg.radix}, tile_rows {tile_rows}, {num_tiles} tiles, "
                                      f"{kind}, pass {p}, {keys.data_ptr() % 16} bytes off")
    check(errs["bucketize_scatter_lookback"] == 0,
          "bucketize_scatter_lookback (radix 2, 4, 16) == plain at tile_rows 1, 3, 8, 16, "
          f"1/8/29 tiles and a ragged last partition, {MANY_TILES} tiles, {MANY_PARTITIONS} "
          "partitions and one more tile; random, skewed, equal and PAD_KEY keys, aligned and "
          "unaligned inputs, first and last pass")
    torch.cuda.empty_cache()


def check_kernels_at_path_shapes(tables: dict, cfg, errs: dict) -> None:
    """The kernels against their plain versions at the path's shapes.

    radix_hist, bucketize, scatter_runs, bucketize_scatter, radix_dest and
    dest_scatter (moving the keys and their index, or, in the compaction, the
    filter's key column):
    the 2^24 keys of the sorts at radix_bits 1, 4 and 8 (bucketize,
    scatter_runs on the kernel's bucketized tiles, and bucketize_scatter at
    4), the filter's 100,000,000 keys at
    radix_bits 4, as the sort of its survivors sees a 100M buffer, and at 1
    and 8, and the filter's 1-bit compaction of them (digit 0 = kept), made
    as filter_table makes it.  key_bits, also against numpy: the 100M padded
    buffers the fused sorts of phase 6 reduce (the filter's keys, its
    survivors' buffer at their live length, its rows past it stale, the
    group-by's keys) and the 2^24 keys; key_bits of each re-padded buffer.
    """
    columns = {"filter keys": tables["filter"]["key"], "filter survivors": tables["kept"],
               "group-by keys": tables["group"]["key"], "2^24 keys": tables["r16m"]}
    for where, col in columns.items():
        keys = sort_ops._repadded(col).data
        host_keys = keys.cpu().numpy()
        want = torch.from_numpy(np.array([np.bitwise_and.reduce(host_keys),
                                          np.bitwise_or.reduce(host_keys)], dtype=np.uint32))
        got = key_bits(keys, impl="cuda")
        err = max(max_abs_err(got, key_bits(keys, impl="reference")),
                  max_abs_err(got.cpu(), want))
        errs["key_bits"] = max(errs["key_bits"], err)
        check(err == 0, f"key_bits == plain == numpy, {where}, {keys.numel()} padded rows")
        del keys
        check_sort_plan(col.data, cfg, errs, f"{where}, {col.padded_length} padded rows, "
                        f"{col.length} live", host=host_keys, length=col.length)
        del host_keys
    del columns
    keys16m = tables["r16m"].data
    flt = tables["filter"]
    padded = flt["key"].padded_length
    mask = keep_low_half(flt).to(torch.int32) * (torch.arange(padded, device=keys16m.device)
                                                  < flt.length)
    compaction = (1 - mask).view(torch.uint32)
    bit_cfg = EngineConfig(radix_bits=1, tile_rows=cfg.tile_rows)
    cases = [(f"2^24 keys radix_bits={bits} shift={shift}", keys16m,
              EngineConfig(radix_bits=bits, tile_rows=cfg.tile_rows), shift)
             for bits in (1, 4, 8) for shift in (0, 28)]
    cases += [(f"filter keys, {padded} rows, radix_bits={bits} shift={shift}", flt["key"].data,
               EngineConfig(radix_bits=bits, tile_rows=cfg.tile_rows), shift)
              for bits, shift in ((4, 0), (4, 28), (1, 0), (8, 0))]
    cases.append((f"filter compaction input, {padded} rows, radix 2", compaction, bit_cfg, 0))
    for where, keys, kcfg, shift in cases:
        hist = rk.tile_histograms(keys, shift, kcfg, impl="reference")
        err = max_abs_err(rk.tile_histograms(keys, shift, kcfg, impl="cuda"), hist)
        errs["radix_hist"] = max(errs["radix_hist"], err)
        check(err == 0, f"radix_hist == plain, {where}")
        offsets = rk.global_offsets(hist)
        err = max_abs_err(rk.tile_destinations(keys, offsets, shift, kcfg, impl="cuda"),
                          rk.tile_destinations(keys, offsets, shift, kcfg, impl="reference"))
        errs["radix_dest"] = max(errs["radix_dest"], err)
        check(err == 0, f"radix_dest == plain, {where}")
        # The columns the path moves: the filter's compaction its key column,
        # a radix pass its keys and their index.
        columns = ([flt["key"].data] if keys is compaction
                   else [keys, iota_index(keys.numel(), kcfg, keys.device)])
        err = max_dest_scatter_err(keys, hist, offsets, shift, kcfg, columns)
        del columns
        errs["dest_scatter"] = max(errs["dest_scatter"], err)
        check(err == 0, f"dest_scatter == plain, {where}")
        if kcfg.radix == 16:
            idx = iota_index(keys.numel(), kcfg, keys.device)
            got = bucketize_tiles(keys, idx, shift, kcfg, impl="cuda")
            err = max(map(max_abs_err, got, _bucketize_ref(keys, idx, shift, kcfg)))
            errs["bucketize"] = max(errs["bucketize"], err)
            check(err == 0, f"bucketize == plain, {where}")
            want = scatter_runs(*got, hist, offsets, kcfg, impl="reference")[:2]
            err = max(map(max_abs_err, scatter_runs(*got, hist, offsets, kcfg, impl="cuda")[:2],
                          want))
            errs["scatter_runs"] = max(errs["scatter_runs"], err)
            check(err == 0, f"scatter_runs == plain, {where}")
            del got
            err = max(map(max_abs_err, bucketize_scatter(keys, idx, hist, offsets, shift, kcfg,
                                                         impl="cuda"), want))
            errs["bucketize_scatter"] = max(errs["bucketize_scatter"], err)
            check(err == 0, f"bucketize_scatter == plain, {where}")
            state = sort_plan(keys, kcfg, torch.zeros(1, dtype=torch.int64, device=keys.device))
            err = max(map(max_abs_err, bucketize_scatter_lookback(
                keys, idx, kcfg, state, shift // kcfg.radix_bits, impl="cuda"), want))
            errs["bucketize_scatter_lookback"] = max(errs["bucketize_scatter_lookback"], err)
            check(err == 0, f"bucketize_scatter_lookback == plain, {where}")
            del idx, want, state
        del hist, offsets
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_main_path(dev, rng, cfg) -> dict:
    """Phase 3: full sorts through the public entry points; returns launch counts."""
    perm_1m = rng.permutation(N_HEADLINE).astype(np.uint32)
    perm_2e20 = rng.permutation(1 << 20).astype(np.uint32)
    pool = rng.integers(0, 2**32, size=1 << 23, dtype=np.uint32)
    dup_16m = rng.choice(pool, size=1 << 24)  # about two copies of each key
    table_keys = rng.integers(0, 2**32, size=N_HEADLINE, dtype=np.uint32)
    payload = rng.integers(-2**31, 2**31, size=(N_HEADLINE, PAYLOAD_COLS), dtype=np.int64)
    payload = payload.astype(np.int32)
    table = Table({
        "key": make_key_column(table_keys, cfg, device=dev),
        **{f"p{j}": make_column(payload[:, j], cfg, device=dev) for j in range(PAYLOAD_COLS)},
    })
    stale = stale_keys(rng, 1 << 21)  # 1M live rows, then stale ones
    stale_name = "1M random live in a 2^21 buffer, stale rows past them"
    sets = {"1M shuffled": perm_1m, "2^20 shuffled": perm_2e20,
            "2^24 random with duplicates": dup_16m, stale_name: stale[:N_HEADLINE]}
    torch.cuda.synchronize()

    # Each sort three times by each method: the first sighting of its shape
    # runs the passes eagerly, the second captures their CUDA graph (where
    # the padded length is within GRAPH_MAX_PADDED), the third replays it;
    # torch's sync debug mode counts each call's synchronising calls.  The
    # cache is cleared before each sort, as the 1M sorts share a shape.  The
    # skip counter is read between the calls, outside the counted window.
    # The host's pass masks are read before the launch counts are reset, so
    # that a window counts the sorts' own launches and nothing else.  Each
    # method's sorts are one window (the fused method's with sort_table):
    # the counts are set to 0 before and read after it.
    cols = {name: make_key_column(keys_np, cfg, device=dev) for name, keys_np in sets.items()}
    cols[stale_name] = Column(torch.from_numpy(stale).to(dev), N_HEADLINE)
    want = {name: cfg.num_passes - bin(pass_mask(sort_ops._repadded(col).data, cfg)).count("1")
            for name, col in cols.items()}
    results, syncs, replays, windows = {}, {}, {}, {}
    table_out = {}
    for method in ("fused", "radix"):
        reset_launches()
        for name, col in cols.items():
            want_skipped = want[name] if method == "fused" else 0
            sort_ops.clear_sort_graphs()
            for call in CALLS:
                skipped = sort_ops.skipped_passes()
                out = []
                syncs[f"sort_pairs {method} {name}", call] = syncs_of(
                    lambda: out.extend(sort_pairs(col, cfg, method=method)))
                s, p = out
                results[method, name, call] = (s.to_numpy(), p.to_numpy(),
                                               bool(device_is_sorted(s.valid())),
                                               sort_ops.skipped_passes() - skipped, want_skipped)
                replays[method, name, call] = graph_replays(), col.padded_length
        if method == "fused":
            sort_ops.clear_sort_graphs()
            for call in CALLS:
                out = []
                syncs["sort_table fused", call] = syncs_of(lambda: out.append(
                    sort_table(table, "key", cfg, method="fused")))
                table_out[call] = {k: out[0][k].to_numpy() for k in out[0].names()}
                replays["sort_table", "", call] = graph_replays(), table["key"].padded_length
        windows[method] = read_launches()
    del cols

    for (method, name, call), (s, p, dev_sorted, skipped, want_skipped) in results.items():
        keys_np = sets[name]
        order = np.argsort(keys_np, kind="stable")
        what = f"sort_pairs {method} {name} ({call})"
        if method == "fused":
            check(skipped == want_skipped, f"{what}: the card's counter says {skipped} of "
                  f"{cfg.num_passes} passes skipped (constant digit), as the host's pass mask")
        else:
            check(skipped == 0, f"{what}: the skip counter did not move (no skip in the radix "
                  "method)")
        check(dev_sorted, f"{what}: device_is_sorted")
        if "shuffled" in name:
            check(is_permutation_sorted(s), f"{what}: keys == arange")
        check(np.array_equal(s, keys_np[order]), f"{what}: keys == np.sort")
        check(np.array_equal(p, order.astype(np.uint32)),
              f"{what}: permutation == np.argsort(kind='stable')")
    order = np.argsort(table_keys, kind="stable")
    for call, cols in table_out.items():
        check(np.array_equal(cols["key"], table_keys[order]), f"sort_table key column ({call})")
        check(all(np.array_equal(cols[f"p{j}"], payload[order, j])
                  for j in range(PAYLOAD_COLS)),
              f"sort_table all {PAYLOAD_COLS} payload columns == payload[argsort] ({call})")
    for (name, call), count in syncs.items():
        log(f"{name} ({call}): {count} synchronising CUDA call(s) (torch sync debug mode)")
        if call != "capture":
            check(count == 0, f"{name} ({call}): no host sync in the sort")
    check(all(count == (CALLS.index(call) if padded <= sort_ops.GRAPH_MAX_PADDED else 0)
              for (*_, call), (count, padded) in replays.items()),
          "each sort's first sighting ran eagerly, its second captured and replayed its graph, "
          "its third replayed it (eager throughout above GRAPH_MAX_PADDED), by both methods")
    fused, radix = windows["fused"], windows["radix"]
    log("launches, fused sorts' window: " + ", ".join(f"{k} {v}" for k, v in fused.items()))
    log("launches, radix sorts' window: " + ", ".join(f"{k} {v}" for k, v in radix.items()))
    sorts = fused["sort_plan"]  # one key read a fused sort
    check(sorts == 3 * len(sets) + len(CALLS) and fused["sort_args"] == sorts
          and fused["bucketize_scatter_lookback"] == cfg.num_passes * sorts
          and all(fused[name] == 0 for name in OFF_FUSED),
          f"the {sorts} fused sorts launched sort_args and sort_plan once each, "
          f"bucketize_scatter_lookback {fused['bucketize_scatter_lookback']} times, once a pass "
          "(a skipped pass's launch exits at once), and "
          + ", ".join(f"{name} {fused[name]}" for name in OFF_FUSED) + " times")
    for name in RADIX_PATH:
        check(radix[name] > 0, f"{name} launched {radix[name]} times by the radix sorts")
    check(radix["dest_scatter"] == radix["radix_hist"] == radix["exclusive_scan"],
          f"the radix sorts launched K1, K5 and dest_scatter once a pass each "
          f"({radix['radix_hist']} passes)")
    check(all(radix[name] == 0 for name in FUSED_PATH + OFF_PATH),
          "the radix sorts launched no kernel of the fused sort's and none off the paths "
          f"(radix_dest {radix['radix_dest']} times)")
    return {name: fused[name] + radix[name] for name in KERNELS}


CALLS = ("first sighting", "capture", "replay")


def graph_replays() -> int:
    """Replays of every cached sort graph so far."""
    return sum(g.replays for g in sort_ops._SORT_GRAPHS.values())


def syncs_of(fn) -> int:
    """Synchronising CUDA calls during ``fn()``, counted by torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Not torch's one-time notice that the mode is a prototype.
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _kernel_name(row: str) -> str:
    """The port's kernel a profiler row names (one of its __global__ functions), or ''.

    A symbol counts whole: scatter_1k_kernel is not bucketize_scatter_1k_kernel.
    """
    return next((name for name, (*_, symbols) in KERNELS.items()
                 if any(re.search(rf"(?<!\w){sym}[(<]", row) for sym in symbols)), "")


def glue_split(rows: dict) -> str:
    """A profile's rows that are none of the port's kernels, largest first, ms a call each."""
    glue = sorted(((ms, row) for row, ms in rows.items() if not _kernel_name(row)), reverse=True)
    return "; ".join(f"{row[:100]} {ms:.4f}" for ms, row in glue) or "none"


def port_kernel_split(rows: dict) -> dict:
    """Device ms of each of the port's kernels among a profile's rows."""
    ours = {}
    for row, ms in rows.items():
        name = _kernel_name(row)
        if name:
            ours[name] = ours.get(name, 0.0) + ms
    return ours


AGGS = {"s": ("val", "sum"), "c": ("val", "count"), "lo": ("val", "min"),
        "hi": ("val", "max"), "m": ("val", "mean")}
N_OPS = 100_000_000  # rows of the filter, the group-by and the join's probe
N_GROUPS = 1_000_000
N_BUILD = 10_000_000  # the join's build side, and join_expand's probe and build
N_LARGE = 1 << 24  # the radix method's larger sort
HALF = 1 << 31


def keep_low_half(t: Table) -> torch.Tensor:
    """Predicate: key < 2^31, the keys whose int32 view is not negative."""
    return int32_bits(t["key"].data) >= 0


def operator_inputs(rng) -> dict:
    """Host columns of the operator phase, made from the seed."""
    d = {}
    # Filter + sort: BASELINE config 3, one column of 100M uint32 keys.
    d["fkeys"] = rng.integers(0, 2**32, N_OPS, dtype=np.uint32)
    # Group-by: BASELINE config 4, cut from 1B to 100M rows; 1M distinct
    # keys, values 0..99.  gid is each row's index into the sorted pool.
    pool = np.unique(rng.integers(0, 2**32, N_GROUPS * 5 // 4, dtype=np.uint32))
    d["pool"] = np.sort(rng.permutation(pool)[:N_GROUPS])
    d["gid"] = rng.integers(0, N_GROUPS, N_OPS, dtype=np.int32)
    d["gkeys"] = d["pool"][d["gid"]]
    d["gvals"] = rng.integers(0, 100, N_OPS, dtype=np.int32)
    # Join: BASELINE config 5, cut 10x on both sides.  10M unique build keys;
    # probe rows hit build row floor(N_BUILD * u^4), a power law under which
    # the first 1% of the build rows take about a third of the hits, and 10%
    # of the probe rows carry a key the build side lacks.
    distinct = rng.permutation(np.unique(rng.integers(0, 2**32, N_BUILD * 23 // 20,
                                                      dtype=np.uint32)))
    d["bkeys"], misses = distinct[:N_BUILD], distinct[N_BUILD:]
    d["bpay"] = rng.integers(0, 2**31 - 1, N_BUILD, dtype=np.int32)
    d["hit_row"] = np.minimum((N_BUILD * rng.random(N_OPS) ** 4).astype(np.int64), N_BUILD - 1)
    d["miss"] = rng.random(N_OPS) < 0.1
    d["pkeys"] = np.where(d["miss"], misses[rng.integers(0, misses.size, N_OPS)],
                          d["bkeys"][d["hit_row"]])
    d["pval"] = rng.integers(0, 2**31 - 1, N_OPS, dtype=np.int32)
    # join_expand: a 10M-row probe against 10M build rows over 5M keys, so
    # about two copies of each key (Poisson) and about 13% of probes miss.
    d["epool"] = np.sort(distinct[: N_BUILD // 2])
    d["eb_gid"] = rng.integers(0, d["epool"].size, N_BUILD)
    d["ep_gid"] = rng.integers(0, d["epool"].size, N_BUILD)
    d["ebv"] = rng.integers(0, 2**31 - 1, N_BUILD, dtype=np.int32)
    d["epv"] = rng.integers(0, 2**31 - 1, N_BUILD, dtype=np.int32)
    d["copies"] = np.bincount(d["eb_gid"], minlength=d["epool"].size)
    d["e_total"] = int(d["copies"][d["ep_gid"]].sum())
    # The radix method at 1M and 2^24 keys.
    d["r1m"] = rng.integers(0, 2**32, N_HEADLINE, dtype=np.uint32)
    d["r16m"] = rng.integers(0, 2**32, N_LARGE, dtype=np.uint32)
    return d


def operator_tables(d: dict, cfg, dev) -> dict:
    def table(key, keys, **cols):
        t = Table({name: make_column(v, cfg, device=dev) for name, v in cols.items()})
        return t.with_column(key, make_key_column(keys, cfg, device=dev))

    return {
        "filter": table("key", d["fkeys"]),
        "group": table("key", d["gkeys"], val=d["gvals"]),
        "probe": table("key", d["pkeys"], pval=d["pval"]),
        "build": table("key", d["bkeys"], payload=d["bpay"]),
        "eprobe": table("k", d["epool"][d["ep_gid"]], pv=d["epv"]),
        "ebuild": table("k", d["epool"][d["eb_gid"]], bv=d["ebv"]),
        "r1m": make_key_column(d["r1m"], cfg, device=dev),
        "r16m": make_key_column(d["r16m"], cfg, device=dev),
        "e_total": d["e_total"],
    }


def host(table: Table) -> dict:
    return {name: table[name].to_numpy() for name in table.names()}


def phase_operators(dev, rng, cfg) -> tuple[dict, dict, dict]:
    """Phase 4: the operator path; returns (launch counts, device inputs for timing, host inputs)."""
    t0 = time.perf_counter()
    d = operator_inputs(rng)
    tables = operator_tables(d, cfg, dev)
    torch.cuda.synchronize()
    log(f"operator inputs made on the host and copied to the card in "
        f"{time.perf_counter() - t0:.1f} s")

    reset_launches()
    kept = filter_table(tables["filter"], keep_low_half, cfg).to_table()
    tables["kept"] = kept["key"]
    out = {"kept": kept["key"].to_numpy(), "kept_sorted": sort_keys(kept["key"], cfg).to_numpy()}
    out["agg"] = host(group_by_aggregate(tables["group"], "key", AGGS, cfg).to_table())
    for how in ("inner", "semi", "anti"):
        out[how] = host(join(tables["probe"], tables["build"], "key", how, cfg).to_table())
    expanded = join_expand(tables["eprobe"], tables["ebuild"], "k", cfg, capacity=d["e_total"])
    out["expand_overflow"] = bool(expanded.overflow)
    out["expand_count"] = int(expanded.count)
    if not out["expand_overflow"]:
        out["expand"] = host(expanded.to_table())
    del expanded
    for name in ("r1m", "r16m"):
        s, p = sort_pairs(tables[name], cfg, method="radix")
        out[name] = (s.to_numpy(), p.to_numpy())
    out["radix8"] = sort_keys(tables["r16m"], EngineConfig(radix_bits=8)).to_numpy()
    launches = read_launches()
    torch.cuda.empty_cache()
    log(f"operator path ran on the card in {time.perf_counter() - t0:.1f} s, inputs included")
    check_operators(d, out)
    for name, count in launches.items():
        if name in OFF_PATH:
            check(count == 0, f"{name}, off the path, launched {count} times on the operator path")
        else:
            check(count > 0, f"{name} launched {count} times on the operator path")
    return launches, tables, d


def group_oracle(d: dict) -> dict:
    """The group-by's expected columns, from one bincount of (group, value): values are 0..99."""
    hist = np.bincount(d["gid"].astype(np.int64) * 100 + d["gvals"],
                       minlength=N_GROUPS * 100).reshape(N_GROUPS, 100)
    counts = hist.sum(axis=1)
    present = counts > 0
    hist, counts = hist[present], counts[present]
    sums = hist @ np.arange(100, dtype=np.int64)
    return {"key": d["pool"][present], "c": counts, "s": sums,
            "lo": np.argmax(hist > 0, axis=1), "hi": 99 - np.argmax(hist[:, ::-1] > 0, axis=1),
            "m": sums / counts}


def check_groups(agg: dict, want: dict, label: str) -> None:
    """Group keys and aggregates against ``group_oracle``: exact, means to rtol 1e-5."""
    check(np.array_equal(agg["key"], want["key"]),
          f"{label}: {want['key'].size} groups, keys == the sorted distinct keys")
    for name, what in (("c", "count"), ("s", "sum (int32)"), ("lo", "min"), ("hi", "max")):
        check(np.array_equal(agg[name], want[name]), f"{label} {what}")
    mean_err = np.max(np.abs(agg["m"] / want["m"] - 1))
    check(agg["m"].dtype == np.float32 and mean_err <= 1e-5,
          f"{label} mean within rtol 1e-5 of float64 (max rel err {mean_err:.2e})")


def check_operators(d: dict, out: dict) -> None:
    """The operator path's results against numpy, exactly (means to rtol 1e-5)."""
    t0 = time.perf_counter()
    want = d["fkeys"][d["fkeys"] < HALF]
    check(np.array_equal(out["kept"], want),
          f"filter_table: {want.size} of {N_OPS} keys < 2^31 kept, in input order")
    check(np.array_equal(out["kept_sorted"], np.sort(want)),
          "sort_keys of the survivors == np.sort")

    check_groups(out["agg"], group_oracle(d), "group_by_aggregate")

    hit = ~d["miss"]
    expect = {"inner": hit, "semi": hit, "anti": d["miss"]}
    for how, rows in expect.items():
        got = out[how]
        ok = (np.array_equal(got["key"], d["pkeys"][rows])
              and np.array_equal(got["pval"], d["pval"][rows]))
        if how == "inner":
            ok = ok and np.array_equal(got["build_payload"], d["bpay"][d["hit_row"][rows]])
        check(ok, f"join {how}: {int(rows.sum())} of {N_OPS} probe rows, every column")

    # join_expand: probe rows in order, each followed through its key's build
    # rows in build order (the stable sort of the build side).
    copies = d["copies"]
    per_probe = copies[d["ep_gid"]]
    total = d["e_total"]
    check(not out["expand_overflow"] and out["expand_count"] == total,
          f"join_expand: {total} matches, no overflow")
    prow = np.repeat(np.arange(N_BUILD), per_probe)
    first = np.repeat(np.cumsum(per_probe) - per_probe, per_probe)
    run_start = np.cumsum(copies) - copies
    brow = run_start[d["ep_gid"][prow]] + np.arange(total) - first
    build_sorted = d["ebv"][np.argsort(d["eb_gid"], kind="stable")]
    got = out["expand"]
    check(np.array_equal(got["k"], d["epool"][d["ep_gid"][prow]])
          and np.array_equal(got["pv"], d["epv"][prow])
          and np.array_equal(got["build_bv"], build_sorted[brow]),
          "join_expand: every (probe, build) pair in order")

    for name in ("r1m", "r16m"):
        keys = d[name]
        order = np.argsort(keys, kind="stable")
        s, p = out[name]
        check(np.array_equal(s, keys[order]) and np.array_equal(p, order.astype(np.uint32)),
              f"sort_pairs radix, {keys.size} keys: keys and permutation == numpy stable")
    check(np.array_equal(out["radix8"], np.sort(d["r16m"])),
          f"sort_keys radix_bits=8 auto (radix method), {d['r16m'].size} keys == np.sort")
    log(f"host checks took {time.perf_counter() - t0:.1f} s")


def global_offsets_cumsum(hist: torch.Tensor) -> torch.Tensor:
    """global_offsets by a library scan: the timing baseline of the exclusive_scan one.

    The (digit, tile)-order int64 ``torch.cumsum``, less its input, narrowed
    to int32.
    """
    num_tiles, radix = hist.shape
    by_digit = hist.t().contiguous().view(-1)
    incl = torch.cumsum(by_digit, dim=0, dtype=torch.int64)
    excl = (incl - by_digit).to(torch.int32)
    return excl.view(radix, num_tiles).t().contiguous()


def eager_loop():
    """Inside the block the fused sort runs its passes by the eager loop, at any length.

    An A/B that swaps a kernel or a function in must time the eager loop: a
    cached graph replays what it captured first.
    """
    return mock.patch.object(sort_ops, "GRAPH_MAX_PADDED", 0)


def ab_per_call_ms(fns: dict, calls: int = 1, rounds: int = 4, reps: int = 4) -> dict:
    """Median per-call ms of each function, sampled in alternating rounds (a b b a ...)."""
    names = list(fns)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name] += per_call_ms(fns[name], calls=calls, reps=reps)
    return {name: float(np.median(v)) for name, v in samples.items()}


GRAPH_AB_SIZES = {
    "fused": (("1M", N_HEADLINE), ("2^22", 1 << 22), ("2^23", 1 << 23), ("12M", 3 << 22),
              ("2^24", 1 << 24), ("2^25", 1 << 25)),
    "radix": (("1M", N_HEADLINE), ("2^22", 1 << 22), ("2^23", 1 << 23), ("12M", 3 << 22),
              ("2^24", 1 << 24)),
}
GRAPH_AB_MAX = 1 << 25


def same_bits(a, b) -> bool:
    return all(torch.equal(int32_bits(x), int32_bits(y)) for x, y in zip(a, b))


def column_data(columns) -> list:
    return [c.data for c in columns]


def graph_ab(dev, rng, cfg, card: str) -> None:
    """Each sort method's passes as the cached CUDA graph against running them eagerly.

    The fused sort at 1M, 2^22, 2^23, 12M (3 x 2^22), 2^24 and 2^25 random
    keys, the radix method at 1M, 2^22, 2^23, 12M and 2^24, each graphed
    here whatever ``GRAPH_MAX_PADDED`` says, so that the limit can be set
    from this: the host time of the
    first three calls of a shape (the eager first sighting; the capture,
    instantiation and one replay; a replay), each equal to the eager passes
    bit for bit, the bytes the graph cache holds (memory reserved after
    ``empty_cache``, less the same after ``clear_sort_graphs``), CUDA-event
    ms per sort in alternating rounds (median of 16 each, beside the
    graph's replay alone), and the profiler's busy time split by kernel, in
    which every kernel of the method must be named inside a replay.
    """
    for method, sizes in GRAPH_AB_SIZES.items():
        graph_ab_method(method, sizes, dev, rng, cfg, card)


def graph_ab_method(method: str, sizes, dev, rng, cfg, card: str) -> None:
    log(f"{method} sort_pairs, passes by the cached CUDA graph against running them eagerly "
        f"({card}); the sorts graph up to GRAPH_MAX_PADDED = {sort_ops.GRAPH_MAX_PADDED} padded "
        f"keys, here up to {sizes[-1][1]}")
    path = FUSED_PATH if method == "fused" else RADIX_PATH
    for label, n in sizes:
        col = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg, device=dev)

        def eager():
            with eager_loop():
                return sort_pairs(col, cfg, method=method)

        fns = {"graphed": lambda: sort_pairs(col, cfg, method=method), "eager": eager}
        with mock.patch.object(sort_ops, "GRAPH_MAX_PADDED", GRAPH_AB_MAX):
            want = column_data(eager())
            sort_ops.clear_sort_graphs()
            torch.cuda.empty_cache()
            calls_ms = []
            for call in CALLS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = column_data(fns["graphed"]())
                torch.cuda.synchronize()
                calls_ms.append((time.perf_counter() - t0) * 1e3)
                check(same_bits(out, want), f"{method} {label}: graphed sort ({call}) == eager "
                      "passes, bit for bit")
            del out, want
            torch.cuda.empty_cache()
            held = torch.cuda.memory_reserved(dev)
            sort_ops.clear_sort_graphs()
            torch.cuda.empty_cache()
            cache_mb = (held - torch.cuda.memory_reserved(dev)) / 2**20
            fns["graphed"]()  # seen, then captured again for the rounds
            # The graph's replay alone: no argument block or copies.  The
            # last call's result is held, so that the block it left names
            # live buffers.
            held = fns["graphed"]()
            replay = next(iter(sort_ops._SORT_GRAPHS.values())).graph.replay
            ms = ab_per_call_ms({**fns, "replay alone": replay})
            parts = [f"replay alone {ms['replay alone']:.4f} ms"]
            for name, fn in fns.items():
                busy, rows = profiled_device_ms(fn, calls=3)
                ours = port_kernel_split(rows)
                if not busy:
                    parts.append(f"{name} {ms[name]:.4f} ms (device busy not measured)")
                    continue
                parts.append(f"{name} {ms[name]:.4f} ms (device busy {busy:.4f} ms, busy share "
                             f"{busy / ms[name]:.3f}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                                   ours.items())
                             + f", other {busy - sum(ours.values()):.4f})")
                if name == "graphed":
                    check(all(k in ours for k in path),
                          f"{method} {label}: every kernel of the sort named in the profile of "
                          "a replay")
                if method == "fused":  # a memset shows as "memset32" inside a graph
                    other = [row for row in rows
                             if not _kernel_name(row) and "memset" not in row.lower()]
                    check(not other, f"fused {label} {name}: no device work but the port's "
                          f"kernels and memsets (other rows: {other or 'none'})")
                if method == "fused" and label == "2^24":
                    log(f"  fused 2^24 {name}: device ms a sort outside the port's kernels, by "
                        f"profiler row: {glue_split(rows)}")
        log(f"time {method} {label} ({col.padded_length} padded keys, {card}): host ms of the "
            f"first calls: " + ", ".join(f"{call} {t:.2f}" for call, t in zip(CALLS, calls_ms))
            + f"; graph cache holds {cache_mb:.1f} MiB; CUDA events, median of 16 in "
            f"alternating rounds: " + "; ".join(parts))
        del col, fns, held
        sort_ops.clear_sort_graphs()
        torch.cuda.empty_cache()


def offsets_passes(keys: torch.Tensor, idx: torch.Tensor, cfg, skipped: torch.Tensor):
    """The fused sort's passes by the table pass: K1, the offsets scan, then bucketize_scatter.

    The A/B's other side, never a fallback.  The plan comes from the AND
    and OR alone (``pass_plan``), and every pass launches K1 and the
    table-reading ``bucketize_scatter`` routed by it, with the offsets
    (``global_offsets``: two transposes and K5) between them.
    """
    plan = pass_plan(keys, cfg, skipped)
    buffers = tuple((torch.empty_like(keys), torch.empty_like(idx)) for _ in range(2))
    for p in range(cfg.num_passes):
        shift, route = p * cfg.radix_bits, dict(plan=plan, pass_index=p, buffers=buffers)
        hist = rk.tile_histograms(keys, shift, cfg, **route)
        bucketize_scatter(keys, idx, hist, rk.global_offsets(hist), shift, cfg, **route)
    return buffers[0]


def table_pass_sort(col: Column, cfg):
    """sort_pairs of ``col`` by the table pass, as the fused sort ran before its argument block.

    The re-padding and the index column by torch, then ``offsets_passes``,
    as a graph that copies its input in and its outputs out (the radix
    method's ``_RadixGraph``) where the shape recurs.  The A/B's other side.
    """
    skipped = sort_ops._skip_counter(col.device)

    def run(data):
        padded = Column(data, col.length)
        return offsets_passes(sort_ops._repadded(padded).data, sort_ops._index_column(padded), cfg,
                              skipped)

    inputs = (col.data,)
    graph = sort_ops._graph_of("table pass", inputs, cfg, lambda: sort_ops._RadixGraph(run, inputs))
    return run(*inputs) if graph is None else graph(*inputs)


PASS_AB_SIZES = (("1M", N_HEADLINE), ("2^24", 1 << 24), ("2^26", 1 << 26))


def pass_ab(dev, rng, cfg, card: str) -> None:
    """The fused sort by look-back against the same sort by the table pass, beside torch.

    ``sort_pairs`` of random keys at 1M, 2^24 and 2^26 by the port (one
    key read, then the look-back pass), by the fused sort with
    ``offsets_passes`` swapped in (K1, offsets and the table-reading pass),
    and by the ``torch`` method, each as a user runs it: a cached graph of
    its own at up to GRAPH_MAX_PADDED keys, eager above.  The table pass
    side (``table_pass_sort``) re-pads and makes the index with torch, as
    the fused sort did before its argument block.  Outputs equal; CUDA
    events ms a sort over the bench's chain of back-to-back sorts, median
    of 16 in alternating rounds; the profiler's busy time a sort, split by
    the port's kernels, and at 2^24 and 2^26 the look-back sort's device
    time outside the port's kernels by profiler row.
    """
    log(f"fused sort_pairs, the look-back pass against the table pass (K1, offsets, "
        f"bucketize_scatter), beside the torch method ({card})")
    for label, n in PASS_AB_SIZES:
        col = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg, device=dev)
        caches = {"look-back pass": ({}, OrderedDict()), "table pass": ({}, OrderedDict())}

        def fused_by(name: str):
            graphs, seen = caches[name]

            def run():
                with contextlib.ExitStack() as stack:
                    stack.enter_context(mock.patch.object(sort_ops, "_SORT_GRAPHS", graphs))
                    stack.enter_context(mock.patch.object(sort_ops, "_SEEN", seen))
                    if name == "table pass":
                        return table_pass_sort(col, cfg)
                    return sort_pairs(col, cfg, method="fused")
            return run

        fns = {name: fused_by(name) for name in caches}
        fns["torch"] = lambda: sort_pairs(col, cfg, method="torch")
        outs = {name: column_data(fn()) if name != "table pass" else list(fn())
                for name, fn in fns.items()}
        check(same_bits(outs["look-back pass"], outs["table pass"])
              and same_bits(outs["look-back pass"], outs["torch"]),
              f"pass A/B {label}: both fused passes and the torch method give one result")
        del outs
        calls = chain_for(n)
        ms = ab_per_call_ms(fns, calls=calls)
        parts = []
        for name, fn in fns.items():
            busy, rows = profiled_device_ms(fn, calls=3)
            how = "" if name == "torch" else ", graph" if caches[name][0] else ", eager"
            if not busy:
                parts.append(f"{name} {ms[name]:.4f} ms (device busy not measured{how})")
                continue
            ours = port_kernel_split(rows)
            split = "".join(f", {k} {v:.4f}" for k, v in ours.items())
            if name != "torch":
                split += f", other {busy - sum(ours.values()):.4f}"
            parts.append(f"{name} {ms[name]:.4f} ms (device busy {busy:.4f} ms{how}{split})")
            if name == "look-back pass" and label != "1M":
                log(f"  fused {label} ({how[2:]}): device ms a sort outside the port's kernels, "
                    f"by profiler row: {glue_split(rows)}")
        log(f"time pass A/B {label} ({col.padded_length} padded keys, {card}): CUDA events ms a "
            f"sort over {calls} back-to-back sorts, median of 16 in alternating rounds; "
            + "; ".join(parts))
        torch.cuda.synchronize()
        del col, fns, caches
        torch.cuda.empty_cache()


# Traffic of fused sorts for the graph cache: 12 lengths that differ, each
# sorted once (as join build sides of different sizes are), and 4 lengths
# that recur, each sorted 8 times in turn.
VARYING_LENGTHS = tuple(int(n) for n in np.linspace(N_HEADLINE, 1 << 23, 12))
RECURRING_LENGTHS = (N_HEADLINE, 1 << 21, 1 << 22, 1 << 23)
RECURRENCES = 8


def graph_traffic(dev, rng, cfg, card: str) -> None:
    """Host ms of sequences of fused sorts: the graph cache against the eager loop.

    Each traffic runs by the port's policy (eager at a shape's first
    sighting, captured at its second), by the eager loop, and by a capture
    at the first sighting (the shapes marked seen beforehand, the cache
    room for all), in alternating rounds from an empty cache (median of 7
    each), with the graphs captured and the replays of the policy's last
    round.
    """
    pool = rng.integers(0, 2**32, size=1 << 23, dtype=np.uint32)
    varying, recurring = ([make_key_column(pool[:n], cfg, device=dev) for n in lengths]
                          for lengths in (VARYING_LENGTHS, RECURRING_LENGTHS))
    traffic = {
        f"{len(varying)} lengths {VARYING_LENGTHS[0]}-{VARYING_LENGTHS[-1]}, once each": varying,
        f"{len(recurring)} lengths {RECURRING_LENGTHS}, {RECURRENCES} times each in turn":
            recurring * RECURRENCES,
    }
    for label, cols in traffic.items():
        shapes = {sort_ops.graph_key("fused", (c.data,), cfg) for c in cols}

        def run(how: str) -> float:
            sort_ops.clear_sort_graphs()
            mode = eager_loop() if how == "eager loop" else contextlib.nullcontext()
            if how == "capture at first sighting":  # and room for every shape
                sort_ops._SEEN.update(dict.fromkeys(shapes))
                mode = mock.patch.object(sort_ops, "GRAPH_CACHE_ENTRIES", len(shapes))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mode:
                for c in cols:
                    sort_pairs(c, cfg, method="fused")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        hows = ("policy", "eager loop", "capture at first sighting")
        samples = {how: [] for how in hows}
        for r in range(7):
            for how in (hows if r % 2 == 0 else hows[::-1]):
                samples[how].append(run(how))
        run("policy")
        captured, replayed = len(sort_ops._SORT_GRAPHS), graph_replays()
        sort_ops.clear_sort_graphs()
        torch.cuda.empty_cache()
        log(f"time graph cache traffic, {label}: {len(cols)} fused sort_pairs over "
            f"{len(shapes)} shapes ({card}), host ms of the sequence, median of 7 in "
            f"alternating rounds: "
            + "; ".join(f"{how} {np.median(v):.2f} (rounds {', '.join(f'{t:.2f}' for t in v)})"
                        for how, v in samples.items())
            + f"; the policy captured {captured} graphs and replayed {replayed} times")
    del traffic, varying, recurring, pool
    torch.cuda.empty_cache()


def add_device(st: StageTimes, name: str, ms: float) -> None:
    """Add a device time to ``st``, or log it as not measured (no whole profile)."""
    if ms:
        st.add(name, ms / 1e3)
    else:
        log(f"  {name}: not measured")


def phase_times(dev, rng, cfg, card: str) -> dict:
    """Phase 5: times; returns each kernel's ms, plain_ms, library_ms, bound_ms, bound_by at 1M."""
    graph_ab(dev, rng, cfg, card)
    pass_ab(dev, rng, cfg, card)
    graph_traffic(dev, rng, cfg, card)
    for n, label in ((N_HEADLINE, "1M"), (1 << 24, "16M")):
        col = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                              device=dev)
        fused = lambda: sort_pairs(col, cfg, method="fused")  # noqa: E731
        t_fused = median_per_call_ms(fused, calls=1)
        t_torch = median_per_call_ms(lambda: sort_pairs(col, cfg, method="torch"), calls=1)
        flipped = int32_bits(col.data) ^ torch.iinfo(torch.int32).min
        t_raw = median_per_call_ms(lambda: torch.sort(flipped, stable=True), calls=1)
        log(f"time {label} ({col.padded_length} padded keys, {card}), CUDA events, "
            f"median of 7: sort_pairs fused {t_fused:.4f} ms ({n / t_fused / 1e3:.1f} M "
            f"keys/s); sort_pairs torch (torch.sort of sign-flipped int32 keys + gathers) "
            f"{t_torch:.4f} ms; bare torch.sort of sign-flipped int32 keys {t_raw:.4f} ms")
        reset_launches()
        fused()
        log(f"  launches in one fused sort at {label}: " + ", ".join(
            f"{name} {count}" for name, count in read_launches().items()))
        busy, rows = profiled_device_ms(fused, calls=3)
        if not busy:
            log(f"  profiler, fused {label}: device time not measured")
            continue
        ours = port_kernel_split(rows)
        split = ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
        log(f"  profiler, fused {label}: device busy {busy:.4f} ms per sort ({split}, "
            f"other torch kernels {busy - sum(ours.values()):.4f}); busy share of the "
            f"event time {busy / t_fused:.3f}")

    times = {}
    for n, label in ((N_HEADLINE, "1M"), (1 << 24, "16M")):
        keys = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                               device=dev).data
        idx = iota_index(n, cfg, dev)
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        bk, bi = bucketize_tiles(keys, idx, 0, cfg)
        padded = keys.numel()
        counts = torch.randint(0, 100, (padded,), dtype=torch.int32, device=dev)
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        # One argument block serves sort_plan's calls, as a sort writes one a sort;
        # the look-back pass's device time is its kernel's own.
        args = SortArgs(keys, idx, (torch.empty_like(keys), torch.empty_like(keys)), padded)
        block = sort_args(args)
        state = sort_plan(keys, cfg, skipped, block=block)

        def lookback(impl: str):
            def run():  # a pass index serves one launch: clear its scratch first
                state.lookback.zero_()
                return bucketize_scatter_lookback(keys, idx, cfg, state, 0, impl=impl)
            return run

        # name: (kernel, plain, one library call of the same function or None);
        # the bytes each must move and operations it must do are stage_work's.
        stage = {
            "sort_args": (lambda: sort_args(args, block), lambda: sort_args(args, impl="reference"),
                          None),
            "sort_plan": (lambda: sort_plan(keys, cfg, skipped, impl="cuda", block=block),
                          lambda: sort_plan(keys, cfg, skipped, impl="reference"), None),
            "bucketize_scatter_lookback": (lookback("cuda"), lookback("reference"), None),
            "radix_hist": (lambda: rk.tile_histograms(keys, 0, cfg, impl="cuda"),
                           lambda: rk.tile_histograms(keys, 0, cfg, impl="reference"), None),
            "bucketize": (lambda: bucketize_tiles(keys, idx, 0, cfg, impl="cuda"),
                          lambda: bucketize_tiles(keys, idx, 0, cfg, impl="reference"), None),
            "scatter_runs": (lambda: scatter_runs(bk, bi, hist, offsets, cfg, impl="cuda"),
                             lambda: scatter_runs(bk, bi, hist, offsets, cfg,
                                                  impl="reference"), None),
            "bucketize_scatter": (
                lambda: bucketize_scatter(keys, idx, hist, offsets, 0, cfg, impl="cuda"),
                lambda: bucketize_scatter(keys, idx, hist, offsets, 0, cfg, impl="reference"),
                None),
            "radix_dest": (lambda: rk.tile_destinations(keys, offsets, 0, cfg, impl="cuda"),
                           lambda: rk.tile_destinations(keys, offsets, 0, cfg,
                                                        impl="reference"), None),
            "dest_scatter": (
                lambda: rk.dest_scatter(keys, hist, offsets, 0, cfg, [keys, idx], impl="cuda"),
                lambda: rk.dest_scatter(keys, hist, offsets, 0, cfg, [keys, idx],
                                        impl="reference"), None),
            "exclusive_scan": (lambda: exclusive_scan(counts, impl="cuda"),
                               lambda: exclusive_scan(counts, impl="reference"),
                               lambda: torch.cumsum(counts, 0, dtype=torch.int32)),
            "key_bits": (lambda: key_bits(keys, impl="cuda"),
                         lambda: key_bits(keys, impl="reference"), None),
        }
        work = stage_work(padded, cfg)
        st = StageTimes()
        log(f"one pass at {label} keys, shift 0, radix 16 ({card}): device time "
            f"(profiler) and per-call time of 20 back-to-back calls (CUDA events); "
            f"exclusive_scan of {padded} int32 values, beside torch.cumsum of them; "
            f"bucketize_scatter_lookback's device time its kernel's own, its per-call time "
            f"with the fill of its scratch, which a sort's sort_plan clears once")
        for name, (kernel, plain, library) in stage.items():
            nbytes, ops = work[name]
            # Alternating turns, so both sides see the same card state; the
            # median over turns in which the profiler recorded device time.
            turns = {"k": [], "p": []}
            for side in "kppkkp":
                fn = kernel if side == "k" else plain
                busy, rows = profiled_device_ms(fn, calls=20)
                if side == "k" and name == "bucketize_scatter_lookback":
                    busy = port_kernel_split(rows).get(name, 0.0)  # not the scratch's fill
                turns[side].append(busy)
            dev_k, dev_p = (float(np.median([t for t in turns[side] if t] or [0.0]))
                            for side in "kp")
            wall_k, wall_p = median_per_call_ms(kernel), median_per_call_ms(plain)
            lib_ms = None
            if library is not None:
                lib_ms = profiled_device_ms(library, calls=20)[0] or median_per_call_ms(library)
                st.add(f"{name} library call device", lib_ms / 1e3)
            bound_ms, bound_by = bound_of(nbytes, ops)
            if label == "1M":  # CUDA-event time where the profiler saw nothing
                times[name] = {"ms": dev_k or wall_k, "plain_ms": dev_p or wall_p,
                               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            add_device(st, f"{name} kernel device", dev_k)
            st.add(f"{name} kernel per call", wall_k / 1e3)
            add_device(st, f"{name} plain device", dev_p)
            st.add(f"{name} plain per call", wall_p / 1e3)
            if dev_k:
                rate = nbytes / (dev_k * 1e-3) / 1e12
                log(f"  {name}: {nbytes / 1e6:.1f} MB at {rate:.3f} TB/s, "
                    f"{rate / HBM_PEAK_TBS:.3f} of the 3.35 TB/s peak; bound {bound_ms * 1e3:.2f} "
                    f"us ({bound_by}), share of bound {bound_ms / dev_k:.3f}")
            if name == "radix_hist":
                for tag, fn in (("", rk.global_offsets), (" by cumsum", global_offsets_cumsum)):
                    add_device(st, f"global_offsets{tag} device", profiled_device_ms(
                        lambda fn=fn: fn(hist), calls=20)[0])
                per_call = ab_per_call_ms({"k5": lambda: rk.global_offsets(hist),
                                           "cumsum": lambda: global_offsets_cumsum(hist)},
                                          calls=20, rounds=2, reps=7)
                st.add("global_offsets per call", per_call["k5"] / 1e3)
                st.add("global_offsets by cumsum per call", per_call["cumsum"] / 1e3)
        for line in st.report().splitlines():
            log("  " + line)

    keys_np = rng.integers(0, 2**32, size=N_HEADLINE, dtype=np.uint32)
    payload = rng.integers(-2**31, 2**31, size=(N_HEADLINE, PAYLOAD_COLS), dtype=np.int64)
    payload = payload.astype(np.int32)
    table = Table({
        "key": make_key_column(keys_np, cfg, device=dev),
        **{f"p{j}": make_column(payload[:, j], cfg, device=dev) for j in range(PAYLOAD_COLS)},
    })
    t_table = median_per_call_ms(lambda: sort_table(table, "key", cfg, method="fused"),
                                 calls=1)
    log(f"time sort_table 1M rows x 64 B (key + 16 int32 columns, {card}), CUDA events, "
        f"median of 7: {t_table:.4f} ms ({N_HEADLINE / t_table / 1e3:.1f} M rows/s)")
    return times


def median_measured(turns: list[float]) -> float:
    """The median of the turns in which the profiler recorded device time, else 0."""
    return float(np.median([t for t in turns if t] or [0.0]))


def phase_dest_scan_times(dev, rng, card: str) -> None:
    """Phase 5, continued: the radix pass's kernels, key_bits, sort_plan, exclusive_scan.

    At radix 2, 16 and 256 on (key, index) pairs: dest_scatter, K4 then
    ``scatter_by_destination`` (the stores it replaces, the same function),
    K4 alone and K1, in alternating turns.  sort_plan on random keys, on keys of which 99% are one key (so
    every lane adds to one counter of each pass) and on equal keys.

    At 1M, 2^24 and 100M keys (padded as the sorts pad them): device time
    per call from the profiler (20 back-to-back calls, median of 3 turns),
    the bound and the share of it; exclusive_scan of a vector of int32 0..99
    beside ``torch.cumsum`` of it, in alternating turns.
    """
    log(f"dest_scatter, K4 + scatter_by_destination, radix_dest, radix_hist, key_bits and "
        f"exclusive_scan at 1M, 2^24 and 100M ({card}): device us per call (profiler, 20 calls, "
        f"median of 3 turns in alternating order), bound, share of bound")
    for label, n in (("1M", N_HEADLINE), ("2^24", N_LARGE), ("100M", N_OPS)):
        keys = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), EngineConfig(),
                               device=dev).data
        padded = keys.numel()
        idx = iota_index(n, EngineConfig(), dev)
        for bits in (1, 4, 8):
            kcfg = EngineConfig(radix_bits=bits)
            hist = rk.tile_histograms(keys, 0, kcfg)
            offsets = rk.global_offsets(hist)
            fns = {
                "dest_scatter": lambda: rk.dest_scatter(keys, hist, offsets, 0, kcfg,
                                                        [keys, idx]),
                "K4 + scatter_by_destination": lambda: scatter_by_destination(
                    rk.tile_destinations(keys, offsets, 0, kcfg), [keys, idx]),
                "radix_dest": lambda: rk.tile_destinations(keys, offsets, 0, kcfg),
                "radix_hist": lambda: rk.tile_histograms(keys, 0, kcfg),
            }
            turns = {name: [] for name in fns}
            for names in (list(fns), list(fns)[::-1], list(fns)):
                for name in names:
                    turns[name].append(1e3 * profiled_device_ms(fns[name], calls=20)[0])
            work = stage_work(padded, kcfg)
            for name, t in turns.items():
                us = median_measured(t)
                bound_ms, by = bound_of(*work["dest_scatter" if "scatter" in name else name])
                share = f"{bound_ms * 1e3 / us:.3f}" if us else "not measured"
                log(f"  {name} radix {kcfg.radix} @ {label} ({padded} keys): {us:.2f} us (turns "
                    f"{', '.join(f'{x:.2f}' for x in t)}); bound {bound_ms * 1e3:.2f} us ({by}); "
                    f"share of bound {share}")
            del hist, offsets, fns
            torch.cuda.empty_cache()
        del idx
        us = 1e3 * median_measured([profiled_device_ms(lambda: key_bits(keys), calls=20)[0]
                                    for _ in range(3)])
        work = stage_work(padded, EngineConfig())
        bound_ms, by = bound_of(*work["key_bits"])
        share = f"{bound_ms * 1e3 / us:.3f}" if us else "not measured"
        log(f"  key_bits @ {label} ({padded} keys): {us:.2f} us; bound {bound_ms * 1e3:.2f} us "
            f"({by}); share of bound {share}")
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        bound_ms, by = bound_of(*work["sort_plan"])
        block = torch.empty(ARGS_WORDS, dtype=torch.int64, device=dev)
        for kind in ("random", "skewed", "equal"):
            if kind == "skewed":  # one key, so one digit of every pass, holds 99%
                keys = torch.where(torch.rand(padded, device=dev) < 0.99,
                                   torch.tensor(0x5A5A5A5A, dtype=torch.int32, device=dev),
                                   int32_bits(keys)).view(torch.uint32)
            elif kind == "equal":
                keys = torch.full((padded,), 0x5A5A5A5A, dtype=torch.int32,
                                  device=dev).view(torch.uint32)
            sort_args(SortArgs(keys, None, (None, None), padded), block)
            turns = [1e3 * profiled_device_ms(
                lambda: sort_plan(keys, EngineConfig(), skipped, block=block), calls=20)[0]
                for _ in range(3)]
            us = median_measured(turns)
            share = f"{bound_ms * 1e3 / us:.3f}" if us else "not measured"
            log(f"  sort_plan ({kind} keys) @ {label} ({padded} keys): {us:.2f} us (turns "
                f"{', '.join(f'{t:.2f}' for t in turns)}); bound {bound_ms * 1e3:.2f} us ({by}); "
                f"share of bound {share}")
        del keys
        x = torch.from_numpy(rng.integers(0, 100, padded, dtype=np.int32)).to(dev)
        turns = {"k": [], "l": []}
        for side in "kllk":
            fn = ((lambda: exclusive_scan(x)) if side == "k"
                  else (lambda: torch.cumsum(x, 0, dtype=torch.int32)))
            turns[side].append(1e3 * profiled_device_ms(fn, calls=20)[0])
        k_us, l_us = (median_measured(turns[side]) for side in "kl")
        bound_ms, by = bound_of(*work["exclusive_scan"])
        share = f"{bound_ms * 1e3 / k_us:.3f}" if k_us else "not measured"
        log(f"  exclusive_scan vector @ {label} ({padded} int32): {k_us:.2f} us (turns "
            f"{', '.join(f'{t:.2f}' for t in turns['k'])}); torch.cumsum {l_us:.2f} us (turns "
            f"{', '.join(f'{t:.2f}' for t in turns['l'])}); bound {bound_ms * 1e3:.2f} us ({by}); "
            f"share of bound {share}")
        del x
        torch.cuda.empty_cache()


def phase_scatter_times(dev, rng, card: str) -> None:
    """Phase 5, continued: one radix-16 pass timed directly at 1M, 2^24 and 100M keys.

    The look-back pass (the fused sort's: its kernel's own device time, its
    scratch cleared before each launch as a sort's sort_plan clears it once),
    the table pass whole (K1, global_offsets, then bucketize_scatter reading
    the table), bucketize_scatter alone, and K2 and K3 on the same input (K3
    on K2's bucketized tiles): device time per call from the profiler (20
    back-to-back calls, median of 3 turns, the sides in alternating turns),
    the bound (stage_work's bytes at 3.35 TB/s) and the share of it.
    """
    cfg = EngineConfig()
    log(f"the look-back pass, the table pass whole, bucketize_scatter, bucketize and scatter_runs at "
        f"1M, 2^24 and 100M, radix 16 ({card}): device us per call (profiler, 20 calls, median of "
        f"3 turns), bound, share of bound")
    for label, n in (("1M", N_HEADLINE), ("2^24", N_LARGE), ("100M", N_OPS)):
        keys = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                               device=dev).data
        idx = iota_index(n, cfg, dev)
        padded = keys.numel()
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        bk, bi = bucketize_tiles(keys, idx, 0, cfg)
        state = sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64, device=dev))

        def lookback():
            state.lookback.zero_()  # a pass index serves one launch
            return bucketize_scatter_lookback(keys, idx, cfg, state, 0)

        def table_pass_whole():
            h = rk.tile_histograms(keys, 0, cfg)
            return bucketize_scatter(keys, idx, h, rk.global_offsets(h), 0, cfg)

        fns = {"bucketize_scatter_lookback": lookback,
               "table pass whole (K1, global_offsets, bucketize_scatter)": table_pass_whole,
               "bucketize_scatter": lambda: bucketize_scatter(keys, idx, hist, offsets, 0, cfg),
               "bucketize": lambda: bucketize_tiles(keys, idx, 0, cfg),
               "scatter_runs": lambda: scatter_runs(bk, bi, hist, offsets, cfg)}
        turns = {name: [] for name in fns}
        for names in (list(fns), list(fns)[::-1], list(fns)):
            for name in names:
                busy, rows = profiled_device_ms(fns[name], calls=20)
                if name == "bucketize_scatter_lookback":
                    busy = port_kernel_split(rows).get(name, 0.0)  # not the scratch's fill
                turns[name].append(1e3 * busy)
        work = stage_work(padded, cfg)
        work["table pass whole (K1, global_offsets, bucketize_scatter)"] = tuple(
            sum(work[k][i] for k in ("radix_hist", "global_offsets", "bucketize_scatter"))
            for i in (0, 1))
        for name, t in turns.items():
            us = median_measured(t)
            bound_ms, by = bound_of(*work[name])
            share = f"{bound_ms * 1e3 / us:.3f}" if us else "not measured"
            log(f"  {name} @ {label} ({padded} keys): {us:.2f} us (turns "
                f"{', '.join(f'{x:.2f}' for x in t)}); bound {bound_ms * 1e3:.2f} us ({by}); "
                f"share of bound {share}")
        del keys, idx, bk, bi, hist, offsets, fns, state
        torch.cuda.empty_cache()


def phase_operator_times(tables: dict, cfg, card: str) -> None:
    """Phase 6: each operator by CUDA events (median of 3), with the busy share.

    Then the graph cache after this traffic: its graphs, the fused sorts
    that replayed one, and the bytes it holds.
    """
    t = tables
    sort_ops.clear_sort_graphs()
    sorts = sort_plan.launches  # one a fused sort of a CUDA buffer
    cfg8 = EngineConfig(radix_bits=8)
    ops = {
        "filter_table + to_table, 100M keys": lambda: filter_table(
            t["filter"], keep_low_half, cfg).to_table(),
        "sort_keys of the ~50M survivors (100M padded buffer)": lambda: sort_keys(t["kept"], cfg),
        "group_by_aggregate + to_table, 100M rows, 1M keys, 5 aggregates": lambda: (
            group_by_aggregate(t["group"], "key", AGGS, cfg).to_table()),
        **{f"join {how} + to_table, 100M probe x 10M build": (
            lambda how=how: join(t["probe"], t["build"], "key", how, cfg).to_table())
           for how in ("inner", "semi", "anti")},
        "join_expand + to_table, 10M probe x 10M build (~2 copies per key)": lambda: join_expand(
            t["eprobe"], t["ebuild"], "k", cfg, capacity=t["e_total"]).to_table(),
        "sort_pairs radix 1M": lambda: sort_pairs(t["r1m"], cfg, method="radix"),
        "sort_pairs fused 1M": lambda: sort_pairs(t["r1m"], cfg, method="fused"),
        "sort_pairs radix 2^24": lambda: sort_pairs(t["r16m"], cfg, method="radix"),
        "sort_pairs fused 2^24": lambda: sort_pairs(t["r16m"], cfg, method="fused"),
        "sort_keys radix_bits=8 auto 2^24": lambda: sort_keys(t["r16m"], cfg8),
        "sort_keys radix_bits=4 auto (fused) 2^24": lambda: sort_keys(t["r16m"], cfg),
    }
    log(f"operator times ({card}): CUDA events, median of 3 after one warm-up; device busy "
        f"time per call from the profiler (two calls, so that a dropped launch shows), and "
        f"its share of the event time")
    for label, fn in ops.items():
        ms = float(np.median(per_call_ms(fn, calls=1, reps=3)))
        busy, rows = profiled_device_ms(fn, calls=2)
        ours = port_kernel_split(rows)
        split = ", ".join(f"{k} {v:.3f}" for k, v in ours.items())
        if not busy:
            log(f"  {label}: {ms:.3f} ms; device busy not measured")
            continue
        log(f"  {label}: {ms:.3f} ms; device busy {busy:.3f} ms, busy share {busy / ms:.3f} "
            f"({split or 'no kernel of the port'})")
    sorts = sort_plan.launches - sorts
    graphs = {f"{key[3]} {key[1]}": g.replays for key, g in sort_ops._SORT_GRAPHS.items()}
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    sort_ops.clear_sort_graphs()
    torch.cuda.empty_cache()
    cache_mb = (held - torch.cuda.memory_reserved()) / 2**20
    log(f"graph cache after phase 6: {len(graphs)} graphs (method and padded length: replays "
        f"{', '.join(f'{n}: {r}' for n, r in graphs.items())}) holding {cache_mb:.1f} MiB; "
        f"{sorts} fused sorts; {sum(graphs.values())} sorts of both methods replayed a graph "
        f"({len(graphs)} of those captured it)")


DIST_RANKS = 4
DIST_TIMEOUT = 600.0
DIST_KERNELS = ("radix_hist", "dest_scatter", "exclusive_scan")  # every rank must launch these


def _save_padded(tmp: str, name: str, arr: np.ndarray, fill, multiple: int) -> str:
    """Write ``arr`` padded with ``fill`` to a multiple of ``multiple`` rows; return the path."""
    out = np.full(round_up(arr.size, multiple), fill, dtype=arr.dtype)
    out[: arr.size] = arr
    path = os.path.join(tmp, f"{name}.npy")
    np.save(path, out)
    return path


def _by_shard(ranks: list, i: int) -> list:
    """Call i's result of every rank, in shard order."""
    return sorted((r[i] for r in ranks), key=lambda x: x["shard"])


def report_dist(label: str, shards: list, live_total: int, card: str, launches: dict) -> None:
    """Per-rank checks and times of one distributed op; adds its launches to ``launches``."""
    for x in shards:
        check(not x["overflow"], f"{label}: shard {x['shard']} no overflow")
        for name in DIST_KERNELS:
            check(x["launches"][name] > 0,
                  f"{label}: {name} launched {x['launches'][name]} times on shard {x['shard']}")
        check(x["launches"]["radix_dest"] == 0,
              f"{label}: radix_dest, on no path, launched {x['launches']['radix_dest']} times on "
              f"shard {x['shard']}")
        for name, count in x["launches"].items():
            launches[name] = launches.get(name, 0) + count
    counts = shards[0]["counts"]
    check(all(np.array_equal(x["counts"], counts) for x in shards)
          and int(counts.sum()) == live_total,
          f"{label}: counts {counts.tolist()} agree on every shard and sum to {live_total}")
    transport = shards[0]["transport"]
    where = ("gloo, host-staged, one card: says nothing about NVLink"
             if transport == "gloo via host" else transport)
    log(f"time dist {label} ({card}; exchange {where}): wall {shards[0]['wall_s']:.3f} s "
        f"after synchronize and barrier; per rank: " + "; ".join(
            f"shard {x['shard']} " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                               for k, v in x["split_s"].items())
            for x in shards))


def check_sorted(gathered, keys: np.ndarray, order: np.ndarray, label: str) -> None:
    out_k, out_i = gathered
    check(np.array_equal(out_k, keys[order]), f"{label}: keys == np.sort")
    check(np.array_equal(out_i, order.astype(np.uint32)),
          f"{label}: index == np.argsort(kind='stable')")


def phase_distributed(d: dict, cfg, card: str) -> dict:
    """Phase 7: the distributed layer on the card; returns the ranks' launch counts, summed.

    Four gloo ranks on cuda:0 run ``dist_sort_pairs`` (all_to_all, then the
    ring), ``dist_group_by_aggregate`` and ``dist_join_inner`` on phase 4's
    inputs; one NCCL rank runs ``dist_sort_pairs`` at 2^24 and
    ``dist_join_inner`` on the join_expand inputs.  The numpy oracles run on
    host threads while the ranks work.
    """
    launches: dict = {}
    hit = ~d["miss"]
    m = DIST_RANKS * cfg.block
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        f = {name: _save_padded(tmp, name, d[name], fill, m) for name, fill in (
            ("fkeys", np.uint32(PAD_KEY)), ("gkeys", np.uint32(PAD_KEY)), ("gvals", np.int32(0)),
            ("pkeys", np.uint32(PAD_KEY)), ("pval", np.int32(0)), ("bkeys", np.uint32(PAD_KEY)),
            ("bpay", np.int32(0)))}
        log(f"distributed inputs written as .npy in {time.perf_counter() - t0:.1f} s; "
            f"{DIST_RANKS} gloo ranks on cuda:0 map their shards")
        sort_order = pool.submit(np.argsort, d["fkeys"], kind="stable")
        join_order = pool.submit(np.argsort, d["pkeys"][hit], kind="stable")
        sort_kw = {"cfg": cfg, "n_live": N_OPS}
        calls = [
            {"op": "sort", "inputs": {"keys": f["fkeys"]}, "kwargs": sort_kw,
             "warmup": True, "shards": False, "gather": True},
            {"op": "sort", "inputs": {"keys": f["fkeys"]}, "kwargs": {**sort_kw, "overlap": True},
             "warmup": True, "shards": False, "gather": True},
            {"op": "aggregate", "inputs": {"keys": f["gkeys"], "values": {"val": f["gvals"]}},
             "kwargs": {"aggs": AGGS, "cfg": cfg, "n_live": N_OPS},
             "warmup": True, "shards": False, "gather": True},
            {"op": "join", "inputs": {"probe_keys": f["pkeys"], "probe_values": f["pval"],
                                      "build_keys": f["bkeys"], "build_values": f["bpay"]},
             "kwargs": {"cfg": cfg, "n_probe": N_OPS, "n_build": N_BUILD},
             "warmup": True, "shards": False, "gather": True},
        ]
        t0 = time.perf_counter()
        ranks = run_ranks(DIST_RANKS, run_ops, (calls,), "gloo", "cuda:0", DIST_TIMEOUT)
        log(f"{DIST_RANKS} gloo ranks ran 4 distributed ops in {time.perf_counter() - t0:.1f} s, "
            f"spawn and results included; transport: {ranks[0][0]['transport']}")
        groups = group_oracle(d)
        for i, label in enumerate(("dist_sort_pairs all_to_all, 100M keys",
                                   "dist_sort_pairs ring (overlap=True), 100M keys")):
            shards = _by_shard(ranks, i)
            report_dist(label, shards, N_OPS, card, launches)
            check_sorted(shards[0]["gathered"], d["fkeys"], sort_order.result(), label)
        shards = _by_shard(ranks, 2)
        label = "dist_group_by_aggregate, 100M rows, 1M keys"
        report_dist(label, shards, groups["key"].size, card, launches)
        gkeys, gvals = shards[0]["gathered"]
        check_groups({"key": gkeys, **gvals}, groups, label)
        shards = _by_shard(ranks, 3)
        label = "dist_join_inner, 100M probe x 10M build"
        report_dist(label, shards, int(hit.sum()), card, launches)
        order = join_order.result()
        k, pv, bv = shards[0]["gathered"]
        check(np.array_equal(k, d["pkeys"][hit][order])
              and np.array_equal(pv, d["pval"][hit][order])
              and np.array_equal(bv, d["bpay"][d["hit_row"][hit]][order]),
              f"{label}: every hit probe row in key order, probe order within a key, "
              f"with its build payload")
        del ranks, shards, k, pv, bv

        # One NCCL rank: every collective of the layer on CUDA tensors.
        ek, eb = d["epool"][d["ep_gid"]], d["epool"][d["eb_gid"]]
        e = {name: _save_padded(tmp, name, arr, fill, cfg.block) for name, arr, fill in (
            ("r16m", d["r16m"], np.uint32(PAD_KEY)), ("ek", ek, np.uint32(PAD_KEY)),
            ("epv", d["epv"], np.int32(0)), ("eb", eb, np.uint32(PAD_KEY)),
            ("ebv", d["ebv"], np.int32(0)))}
        r16m_order = pool.submit(np.argsort, d["r16m"], kind="stable")
        want_join = pool.submit(join_oracle, ek, d["epv"], eb, d["ebv"])
        calls = [
            {"op": "sort", "inputs": {"keys": e["r16m"]}, "kwargs": {"cfg": cfg},
             "warmup": True, "shards": False, "gather": True},
            {"op": "join", "inputs": {"probe_keys": e["ek"], "probe_values": e["epv"],
                                      "build_keys": e["eb"], "build_values": e["ebv"]},
             "kwargs": {"cfg": cfg, "n_probe": N_BUILD, "n_build": N_BUILD},
             "warmup": True, "shards": False, "gather": True},
        ]
        t0 = time.perf_counter()
        ranks = run_ranks(1, run_ops, (calls,), "nccl", "cuda:0", DIST_TIMEOUT)
        log(f"1 NCCL rank ran 2 distributed ops in {time.perf_counter() - t0:.1f} s, spawn "
            f"included; transport: {ranks[0][0]['transport']}")
        label = "dist_sort_pairs, 1 NCCL rank, 2^24 keys"
        report_dist(label, _by_shard(ranks, 0), N_LARGE, card, launches)
        check_sorted(ranks[0][0]["gathered"], d["r16m"], r16m_order.result(), label)
        label = "dist_join_inner, 1 NCCL rank, join_expand's 10M x 10M (duplicate build keys)"
        report_dist(label, _by_shard(ranks, 1), d["e_total"], card, launches)
        check(all(np.array_equal(g, w) for g, w in zip(ranks[0][1]["gathered"],
                                                       want_join.result())),
              f"{label}: every (probe, build) pair, key order, probe order within a key, "
              f"build order within a probe row")
    return launches


BENCH_TIMEOUT = 600.0


def phase_bench(card: str) -> None:
    """Phase 8: the bench module at its headline size, as a user runs it.

    ``python -m gpuradixsort_tpu_torch.bench --sizes 1000000`` in a child
    process (every method and check, the stage table, the table sort), its
    stage table written to a temporary directory.  Its log and its JSON line
    are logged here; it must exit 0, and its line and its table must name
    this card.
    """
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "gpuradixsort_tpu_torch.bench", "--sizes", str(N_HEADLINE),
             "--out", tmp],
            capture_output=True, text=True, timeout=BENCH_TIMEOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in done.stderr.splitlines():
            log(f"  {line}")
        check(done.returncode == 0, f"python -m gpuradixsort_tpu_torch.bench --sizes {N_HEADLINE} "
              f"exited {done.returncode} in {time.perf_counter() - t0:.1f} s")
        last = done.stdout.splitlines()[-1]
        log(f"bench JSON line: {last}")
        result = json.loads(last)
        with open(os.path.join(tmp, DURATIONS_FILE)) as f:
            first = f.readline().strip()
    name, limit = (s.strip() for s in card.rsplit(",", 1))
    check(result["device"] == {"name": name, "power_limit": limit} and first == card,
          f"the bench's JSON line and {DURATIONS_FILE} name this card")
    check(result["value"] is not None and result["value"] > 0,
          f"the bench's headline: {result['value']} keys/s, vs_baseline {result['vs_baseline']}")


def main() -> int:
    if not torch.cuda.is_available():
        log("FAIL no CUDA device: torch.cuda.is_available() is False")
        return 1
    dev = torch.device("cuda", 0)
    cfg = EngineConfig()
    rng = np.random.default_rng(SEED)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}; "
        f"device count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {lib._name}")

    errs = {name: 0 for name in KERNELS}
    phase_kernels(dev, rng, errs)
    main_launches = phase_main_path(dev, rng, cfg)
    op_launches, tables, host_inputs = phase_operators(dev, rng, cfg)
    check_kernels_at_path_shapes(tables, cfg, errs)
    times = phase_times(dev, rng, cfg, card)
    phase_dest_scan_times(dev, rng, card)
    phase_scatter_times(dev, rng, card)
    phase_operator_times(tables, cfg, card)
    del tables
    torch.cuda.empty_cache()
    dist_launches = phase_distributed(host_inputs, cfg, card)
    phase_bench(card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s, the build included")

    # launches: the main path's count, the operator path's, and every rank's
    # of the distributed path.
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": main_launches[name] + op_launches[name] + dist_launches.get(name, 0),
         "max_abs_err": errs[name], **times[name]}
        for name, (_, src, replaces, _) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _child_pids() -> list[int]:
    """Pids of this process's children, live or not yet reaped (Linux /proc)."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:  # state, then ppid
            pids.append(int(entry))
    return pids


def stop_children() -> None:
    """Stop every process this script started that is still there.

    ``run_ranks`` joins its ranks, but its spawn context also starts
    multiprocessing's resource tracker, which ignores SIGTERM and would
    outlive this script until it reads the end of its pipe.  It is stopped
    here as CPython's own finalizer stops it; any other child is killed and
    reaped.
    """
    for p in multiprocessing.active_children():
        p.kill()
        p.join(10)
    resource_tracker._resource_tracker._stop()
    for pid in _child_pids():
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
