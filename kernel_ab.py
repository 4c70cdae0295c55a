#!/usr/bin/env python3
"""Time the fused sort's kernels, sort_plan and the look-back pass, beside an older build.

    python3 kernel_ab.py [--old DIR] [--ptxas] [--gather | --probe] [--out FILE]

A fused sort is one ``sort_plan`` (``csrc/sort_plan.cu``: the key read with
every pass's digit counts, the plan and the bases) and one look-back pass a
pass (``csrc/bucketize_scatter.cu``, ``grs_lookback_scatter``).  On one
CUDA card, device time per call (torch.profiler, 20 back-to-back calls) of
each, beside its bound (``bench.stage_work``'s bytes at 3.35 TB/s) and
share of that bound:

- every row live, at 1,000,000, 2^24 and 100,000,000 keys (padded as the
  sorts pad them), random and skewed (one key holding 99%): ``sort_plan``
  and the look-back pass (pass 0 of a radix-16 sort, unplanned);
- 2^24 and 100,000,000 padded keys, random, of which 1%, 50% and 100% are
  live, the rows past the length stale: ``sort_plan``, the look-back pass
  as the last pass of a sort (unplanned: it walks the live partitions and
  writes the pad rows), the look-back pass as a pass that a later one
  follows (pass 0 of a plan that runs all 8: the live partitions alone),
  and the whole sort (argument block, plan and passes, every device row).

``sort_plan`` counts its memsets with its kernels, and reads its keys
through an argument block written once before the turns, as a sort writes
one a sort; the look-back pass is timed by its kernel's own device time,
its scratch cleared before each launch.  A case's bound counts the live
rows (``stage_work`` of the live length).

``--old DIR`` builds an older copy of ``csrc/`` whose entry points read an
argument block (e.g. the parent commit's: ``git archive <commit>
gpuradixsort_tpu_torch/csrc | tar -x -C chip_scratch/parent``) into
``build/kernels_old/`` and times it on the same input in mirrored turns
(new, old, old, new); every output is checked equal to the other side's
(where the new build writes fewer rows, a pass that a later one follows,
over the live rows it writes) and, up to 2^24 keys, the look-back pass to its
plain version.  ``--ptxas`` prints nvcc's register, shared-memory and spill
report of both kernels' sources (and the older ones) and the resident
warps an SM that follow.  The card's name and power limit and one JSON line
of every number end the output; ``--out`` also writes that JSON to a file.
``--gather`` times the payload gather instead (``kernels/gather.py``,
``csrc/gather_rows.cu``): ``gather_columns`` of 1, 4 and 8 int32 columns
through a sort's int32 permutation R (a random order of the live rows,
PAD_INDEX past them) at 1,000,000, 2^24 and 100,000,000 rows of which 1%,
50% and 100% are live, reading R below the live length, beside the route
it replaced (per column an int64 copy of R, ``clamp`` and
``index_select``, over every row), in mirrored turns, every output checked
equal, with the kernel's launches a call (one a column); its bound is
``gather_bytes``.
``--probe`` times the join's probe instead (``kernels/probe.py``,
``csrc/join_probe.cu``): ``join_probe`` with positions (an inner join's)
of 1,000,000, 2^24 and 100,000,000 probe rows, 50% and all of them live,
sorted and random keys (half hits), against build sides of 600, 900,000
and 4,400,000 unique keys, beside the route it replaced over the whole
padded probe (int64 copies of both sides, ``torch.searchsorted``,
``clamp``, an index of the build keys, the compare and the int32 cast), in
mirrored turns, the live rows checked equal; its bound is
``probe.probe_bytes``.  Then the tuning A/B: builds of
``join_probe.cu`` with one constant changed each (``PROBE_VARIANTS``:
searches a thread, threads a block, splitters staged) beside the port's
build at the cells' probes (q3's lineitem and orders probes, q18's first
join), each launched through its own entry point on the same buffers, the
outputs checked equal, in mirrored turns, with ptxas's registers and
spills of each.
The A/B of the table-reading pass at each block size is ``kernel_ab.py`` of
commit b055d90; that against the buffers-as-arguments build, of 3090bf7,
is this script at commit 92b3e3f.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from gpuradixsort_tpu_torch.bench import stage_work
from gpuradixsort_tpu_torch.config import PAD_INDEX, EngineConfig
from gpuradixsort_tpu_torch.core.table import int32_bits, make_key_column, pad_to_tile, round_up
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import scatter as scatter_kernels
from gpuradixsort_tpu_torch.kernels import sort_plan as sp
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.kernels.probe import join_probe, probe_bytes
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.utils.timing import bound_of, card_line, profiled_device_ms

SEED = 20170101
OLD_BUILD = pathlib.Path(__file__).resolve().parent / "build" / "kernels_old"
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
KINDS = ("random", "skewed")
LIVE_SIZES = ("2^24", "100M")
LIVE_SHARES = (0.01, 0.5, 1.0)
PLAIN_UP_TO = 1 << 24  # the look-back pass is also held to its plain version up to here
GATHER_COLUMNS = (1, 4, 8)
PROBE_BUILDS = {"600": 600, "900K": 900_000, "4.4M": 4_400_000}
PROBE_SHARES = (0.5, 1.0)
# A variant of csrc/join_probe.cu: its label and the (line of the source, line in its place)
# pairs that make it.
THREADS = "constexpr int kThreads = 512;"
SEARCHES = "constexpr int kSearches = 4;"
TABLE = "constexpr int kMaxTable = 32768;"
PROBE_VARIANTS = {
    "256 threads": ((THREADS, "constexpr int kThreads = 256;"),),
    "768 threads": ((THREADS, "constexpr int kThreads = 768;"),),
    "1024 threads": ((THREADS, "constexpr int kThreads = 1024;"),),
    "8 searches": ((SEARCHES, "constexpr int kSearches = 8;"),),
    "16384 splitters": ((TABLE, "constexpr int kMaxTable = 16384;"),),
    "24576 splitters": ((TABLE, "constexpr int kMaxTable = 24576;"),),
}
# (label, probe rows, live rows, build keys, order): the cells' probes.
PROBE_CELLS = (("q3 lineitem", 180_000_000, 97_000_000, 4_400_000, "random"),
               ("q3 orders", 45_000_000, 22_000_000, 900_000, "random"),
               ("q18 orders", 45_000_000, 45_000_000, 600, "random"))
VARIANT_BUILD = pathlib.Path(__file__).resolve().parent / "build" / "kernels_ab"

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The older build's entry points (those of commit 92b3e3f).
OLD_SIGNATURES = {
    "grs_sort_args": [_P, _P, _P, _P, _P, _I64, _I64, _P],
    "grs_sort_plan": [_P, _I64, _P, _P, _I, _I, _P, _P, _I64, _P],
    "grs_lookback_scatter": [_P, _P, _P, _I64, _I, _I, _P, _I, _P, _P, _I64, _P],
}
ALL_RUN = sp.plan_of_mask((1 << 8) - 1, 8)  # every pass runs: pass 0 reads the input into S


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args, stream())
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def pair_like(keys: torch.Tensor) -> tuple:
    return torch.empty_like(keys), torch.empty_like(keys)


class New:
    """This build: sort_plan's state and the look-back pass, as the wrappers launch them."""

    label = "new"

    def __init__(self, keys: torch.Tensor, cfg: EngineConfig, length: int):
        self.keys, self.cfg, self.length = keys, cfg, length
        self.skipped = torch.zeros(1, dtype=torch.int64, device=keys.device)
        self.block = sp.sort_args(sp.SortArgs(keys, None, (None, None), length))
        self.plan()

    def plan(self):
        self.state = sp.sort_plan(self.keys, self.cfg, self.skipped, length=self.length,
                                  block=self.block)
        return self.state

    def tables(self) -> list[torch.Tensor]:
        return [self.state.plan, self.state.counts, self.state.bases]

    def clear(self) -> None:
        self.state.lookback.zero_()

    def lookback(self, idx: torch.Tensor):
        """Pass 0 unplanned, a new output: a sort's last pass."""
        return scatter_kernels.bucketize_scatter_lookback(self.keys, idx, self.cfg, self.state, 0,
                                                          length=self.length)

    def followed(self, idx: torch.Tensor, buffers: tuple, block: torch.Tensor):
        """Pass 0 of a plan that runs every pass, into S of ``buffers`` (R, S)."""
        state = self.state._replace(plan=torch.tensor(ALL_RUN, dtype=torch.int32,
                                                      device=self.keys.device))
        scatter_kernels.bucketize_scatter_lookback(self.keys, idx, self.cfg, state, 0, buffers,
                                                   length=self.length, block=block)

    def block_of(self, idx, result) -> torch.Tensor:
        return sp.sort_args(sp.SortArgs(self.keys, idx, result, self.length))

    def sort(self, idx: torch.Tensor, result: tuple):
        """The whole fused sort, eager: argument block, plan and passes into ``result``."""
        return sort_ops._fused_passes(sp.SortArgs(self.keys, idx, result, self.length), self.cfg,
                                      self.skipped)


class Old:
    """The older build: the same state layout and argument block, its passes over every row."""

    label = "old"

    def __init__(self, lib: ctypes.CDLL, keys: torch.Tensor, cfg: EngineConfig, length: int):
        self.lib, self.keys, self.cfg, self.length = lib, keys, cfg, length
        self.at = sp.state_layout(keys.numel() // cfg.tile, cfg)
        self.state = torch.empty(self.at["total"], dtype=torch.int32, device=keys.device)
        self.skipped = torch.zeros(1, dtype=torch.int64, device=keys.device)
        self.block = self.block_of(None, (None, None))
        self.plan()

    def block_of(self, idx, result) -> torch.Tensor:
        block = torch.empty(sp.ARGS_WORDS, dtype=torch.int64, device=self.keys.device)
        ptr = [None if t is None else t.data_ptr() for t in (idx, *result)]
        call(self.lib, "grs_sort_args", block.data_ptr(), self.keys.data_ptr(), *ptr, self.length,
             self.keys.numel())
        return block

    def plan(self, block: torch.Tensor | None = None):
        s, cfg, zeroed = self.state, self.cfg, self.at["counts"].start
        call(self.lib, "grs_sort_plan", (self.block if block is None else block).data_ptr(),
             self.keys.numel(), s.data_ptr(), s[self.at["plan"]].data_ptr(), cfg.num_passes,
             cfg.radix_bits, self.skipped.data_ptr(), s[zeroed:].data_ptr(),
             4 * (s.numel() - zeroed))
        return s

    def tables(self) -> list[torch.Tensor]:
        shape = (self.cfg.num_passes, self.cfg.radix)
        return [self.state[self.at["plan"]], self.state[self.at["counts"]].view(shape),
                self.state[self.at["bases"]].view(shape)]

    def clear(self) -> None:
        self.state[self.at["lookback"]].zero_()

    def _pass(self, block, scratch, plan, p) -> None:
        cfg, s = self.cfg, self.state
        lookback = s[self.at["lookback"]]
        call(self.lib, "grs_lookback_scatter", block.data_ptr(),
             *(None if t is None else t.data_ptr() for t in scratch), self.keys.numel(),
             p * cfg.radix_bits, cfg.radix, None if plan is None else plan.data_ptr(), p,
             s[self.at["bases"]].data_ptr(), lookback.data_ptr(), lookback.numel())

    def lookback(self, idx: torch.Tensor):
        out = pair_like(self.keys)
        self._pass(self.block_of(idx, out), (None, None), None, 0)
        return out

    def followed(self, idx: torch.Tensor, buffers: tuple, block: torch.Tensor):
        plan = torch.tensor(ALL_RUN, dtype=torch.int32, device=self.keys.device)
        self._pass(block, buffers[1], plan, 0)

    def sort(self, idx: torch.Tensor, result: tuple):
        block = self.block_of(idx, result)
        self.plan(block)
        scratch = pair_like(self.keys)
        for p in range(self.cfg.num_passes):
            self._pass(block, scratch, self.state[self.at["plan"]], p)
        return result


def same(a, b) -> bool:
    return all(torch.equal(int32_bits(x), int32_bits(y)) for x, y in zip(a, b, strict=True))


def old_library(csrc: pathlib.Path) -> ctypes.CDLL:
    """The older ``csrc/`` built alone, its two entry points typed as it declares them."""
    lib = ctypes.CDLL(str(_build.build(csrc, OLD_BUILD)))
    for name, argtypes in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def resident_warps(regs: int, smem: int, threads: int) -> int:
    """Warps an H100 SM holds of a kernel: 64K registers, 228 KB of shared memory, 64 warps."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256  # registers are allocated 256 at a time a warp
    by_regs = 65536 // (per_warp * warps)
    by_smem = 233472 // (smem + 1024) if smem else 32  # 1 KB a block is the system's
    return warps * min(by_regs, by_smem, 64 // warps, 32)


def ptxas_report(label: str, csrc: pathlib.Path) -> dict:
    """Registers, spills and shared bytes of each kernel of the sources, by ptxas.

    The plan's source is ``sort_plan.cu``, ``key_bits.cu`` in a copy older
    than its rename.
    """
    report = {}
    for source in ("bucketize_scatter.cu", "sort_plan.cu", "key_bits.cu", "gather_rows.cu",
                   "join_probe.cu"):
        if not (csrc / source).exists():
            continue
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               "/dev/null", str(csrc / source)],
                              capture_output=True, text=True, timeout=300)
        kernel = None
        for line in (done.stdout + done.stderr).splitlines():
            if "Compiling entry" in line:
                kernel = re.search(r"'(\w+)'", line).group(1)
            elif kernel and ("registers" in line or "spill" in line):
                log(f"ptxas {label} {source}: {kernel}: {line.strip()}")
                entry = report.setdefault(kernel, {})
                for key, pattern in (("registers", r"Used (\d+) registers"),
                                     ("smem", r"(\d+) bytes smem"),
                                     ("spill_stores", r"(\d+) bytes spill stores")):
                    m = re.search(pattern, line)
                    if m:
                        entry[key] = int(m.group(1))
            elif "error" in line:
                log(f"ptxas {label} {source}: {line.strip()}")
    for kernel, entry in report.items():
        if "lookback" in kernel and "registers" in entry:
            threads = 256
            entry["resident_warps"] = resident_warps(entry["registers"], entry.get("smem", 0),
                                                     threads)
            log(f"ptxas {label}: {kernel}: {entry}")
    return report


def device_us(fn, only: str | None = None, calls: int = 20) -> float:
    """Device µs a call (only the rows naming ``only`` where given); 0.0 if not measured."""
    total, rows = profiled_device_ms(fn, calls=calls)
    if only is not None:
        total = sum(ms for row, ms in rows.items() if only in row)
    return total * 1e3


def fmt(x: float, digits: int = 2) -> str:
    return f"{x:.{digits}f}" if x else "not measured"


def keys_of(rng, n: int, kind: str) -> np.ndarray:
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "skewed":
        keys = np.where(rng.random(n) < 0.99, np.uint32(0x5A5A5A5A), keys).astype(np.uint32)
    return keys


def turns_of(fns: dict, only: str | None) -> dict:
    """Device µs a call of each side in mirrored turns (new, old, old, new)."""
    turns = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        turns[name].append(device_us(fns[name], only))
    return turns


def record(results: dict, key: str, turns: dict, bound: float, padded: int, live: int) -> None:
    row = {name: float(np.median([t for t in ts if t] or [0.0])) for name, ts in turns.items()}
    results[key] = {**row, "turns": turns, "bound_us": bound, "padded": padded, "live": live}
    log(f"{key} ({padded} keys, {live} live): device us per call, median of mirrored turns: "
        + ", ".join(f"{k} {fmt(v)} (share of bound {fmt(bound / v if v else 0, 3)})"
                    for k, v in row.items()) + f"; bound {bound:.2f} us")


def stale_keys(rng, n: int, length: int, kind: str) -> torch.Tensor:
    """``n`` keys of ``kind`` below ``length``, stale small keys past it, on the card."""
    buf = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    buf[:length] = keys_of(rng, length, kind)
    return torch.from_numpy(buf).cuda()


def measure_all_live(rng, results: dict, old: ctypes.CDLL | None) -> None:
    """sort_plan and the look-back pass with every row live (the kernel table's rows)."""
    cfg = EngineConfig()
    for label, n in SIZES.items():
        for kind in KINDS:
            keys = make_key_column(keys_of(rng, n, kind), cfg).data
            idx = pad_to_tile(torch.arange(n, dtype=torch.int32, device=keys.device)
                              .view(torch.uint32), cfg, PAD_INDEX)
            padded = keys.numel()
            sides = [New(keys, cfg, padded)] + ([Old(old, keys, cfg, padded)] if old else [])
            got = [side.lookback(idx) for side in sides]
            where = f"{label} {kind}"
            if old is not None:
                differ = [name for name, a, b in zip(("plan", "counts", "bases"),
                                                     sides[0].tables(), sides[1].tables())
                          if not torch.equal(a, b)]
                if differ:
                    raise SystemExit(f"sort_plan {where}: the two builds differ in {differ}")
                if not same(*got):
                    raise SystemExit(f"look-back pass {where}: the two builds differ")
            if padded <= PLAIN_UP_TO:
                want = scatter_kernels.bucketize_scatter_lookback(
                    keys, idx, cfg, sides[0].state, 0, impl="reference")
                if not same(got[0], want):
                    raise SystemExit(f"look-back pass {where}: differs from the plain version")
                del want
            del got
            work = stage_work(padded, cfg)
            for kernel, fns, only in (
                    ("sort_plan", {s.label: s.plan for s in sides}, None),
                    ("lookback", {s.label: (lambda s=s: (s.clear(), s.lookback(idx)))
                                  for s in sides}, "lookback_scatter")):
                stage = "sort_plan" if kernel == "sort_plan" else "bucketize_scatter_lookback"
                record(results, f"{kernel} @ {where}", turns_of(fns, only),
                       bound_of(*work[stage])[0] * 1e3, padded, padded)
            del keys, idx, sides
            torch.cuda.empty_cache()


def measure_live_shares(rng, results: dict, old: ctypes.CDLL | None) -> None:
    """The fused sort's kernels on padded buffers of which a share is live, rows past it stale."""
    cfg = EngineConfig()
    for label in LIVE_SIZES:
        n = round_up(SIZES[label], cfg.block)
        for share in LIVE_SHARES:
            length = int(n * share)
            keys = stale_keys(rng, n, length, "random")
            idx = torch.from_numpy(rng.permutation(n).astype(np.uint32)).cuda()
            where = f"{label} padded, {share:.0%} live"
            sides = [New(keys, cfg, length)] + ([Old(old, keys, cfg, length)] if old else [])
            # Each side's outputs: the last pass, the pass a later one follows, the sort.
            outs = []
            for side in sides:
                buffers = (pair_like(keys), pair_like(keys))
                side.clear()
                side.followed(idx, buffers, side.block_of(idx, buffers[0]))
                side.clear()
                outs.append((side.lookback(idx), buffers[1], side.sort(idx, pair_like(keys))))
            live_keys, live_idx = sp.live_input(keys, idx, length)
            order = torch.sort(int32_bits(live_keys).to(torch.int64) & 0xFFFFFFFF,
                               stable=True).indices
            if not same(outs[0][2], (int32_bits(live_keys)[order], int32_bits(live_idx)[order])):
                raise SystemExit(f"fused sort {where}: not the stable sort of the live keys")
            if old is not None:
                (last, followed, result), (old_last, old_followed, old_result) = outs
                if not (same(last, old_last) and same(result, old_result)
                        and same([t[:length] for t in followed],
                                 [t[:length] for t in old_followed])):
                    raise SystemExit(f"{where}: the two builds differ")
            del outs
            work = stage_work(round_up(max(length, 1), cfg.tile), cfg)
            lookback_bytes = work["bucketize_scatter_lookback"][0]
            pads = 8 * (n - length)
            result = pair_like(keys)

            def sort_of(side):
                return lambda: side.sort(idx, result)

            def followed_of(side):
                buffers = (result, pair_like(keys))
                block = side.block_of(idx, result)
                return lambda: (side.clear(), side.followed(idx, buffers, block))

            for kernel, fns, only, nbytes in (
                    ("sort_plan", {s.label: s.plan for s in sides}, None,
                     work["sort_plan"][0]),
                    ("lookback last pass", {s.label: (lambda s=s: (s.clear(), s.lookback(idx)))
                                            for s in sides}, "lookback_scatter",
                     lookback_bytes + pads),
                    ("lookback followed pass", {s.label: followed_of(s) for s in sides},
                     "lookback_scatter", lookback_bytes),
                    ("fused sort", {s.label: sort_of(s) for s in sides}, None,
                     12 * length + pads)):
                record(results, f"{kernel} @ {where}", turns_of(fns, only),
                       bound_of(nbytes, 0)[0] * 1e3, n, length)
            del keys, idx, sides, result
            torch.cuda.empty_cache()


def gather_bytes(n: int, live: int, row_bytes: int, index_bytes: int = 4) -> int:
    """The gather's HBM bytes: the live rows' index, rows read and written; the rest written."""
    return live * (index_bytes + 2 * row_bytes) + (n - live) * row_bytes


def parent_gather(cols: list, src: torch.Tensor) -> list:
    """The route the kernel replaced, a column at a time: an int64 copy, clamp, index_select."""
    return [int32_bits(v).index_select(0, src.to(torch.int64).clamp(0, v.shape[0] - 1))
            .view(v.dtype) for v in cols]


def measure_gather(rng, results: dict) -> None:
    """gather_columns against the route it replaced, through a sort's padded permutation."""
    for label, n in SIZES.items():
        for share in LIVE_SHARES:
            live = int(n * share)
            src = torch.full((n,), -1, dtype=torch.int32, device="cuda")  # PAD_INDEX as int32
            src[:live] = torch.from_numpy(rng.permutation(live).astype(np.int32)).cuda()
            for count in GATHER_COLUMNS:
                cols = [torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
                        .cuda() for _ in range(count)]
                before = gather_columns.launches
                got = gather_columns(cols, src, live)
                launches = gather_columns.launches - before
                if not same(got, parent_gather(cols, src)):
                    raise SystemExit(f"gather {label} {share:.0%} live {count} columns: the "
                                     "kernel differs from the route it replaced")
                del got
                fns = {"kernel": lambda: gather_columns(cols, src, live),
                       "parent": lambda: parent_gather(cols, src)}
                key = f"gather {count} int32 columns @ {label}, {share:.0%} live"
                record(results, key, turns_of(fns, None),
                       bound_of(gather_bytes(n, live, 4 * count), 0)[0] * 1e3, n, live)
                results[key]["launches"] = launches
                log(f"  {key}: {launches} launch(es) a call")
                del cols
                torch.cuda.empty_cache()
            del src


def probe_build(rng, nb: int) -> torch.Tensor:
    """``nb`` unique uint32 keys, sorted, on the card."""
    pool = np.unique(rng.integers(0, 2**32, nb + nb // 8 + 8, dtype=np.uint32))
    return torch.from_numpy(np.sort(rng.permutation(pool)[:nb])).cuda()


def probe_keys(rng, n: int, live: int, build: torch.Tensor, order: str) -> torch.Tensor:
    """``n`` probe keys, half of the ``live`` ones hits, sorted or random; stale past ``live``."""
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hits = rng.random(live) < 0.5
    keys[:live][hits] = build.cpu().numpy()[rng.integers(0, build.numel(), int(hits.sum()))]
    if order == "sorted":
        keys[:live].sort()
    return torch.from_numpy(keys).cuda()


def replaced_probe(keys: torch.Tensor, build: torch.Tensor) -> tuple:
    """The route join_probe replaced, over every padded row: int64 copies, search, clamp, index."""
    nb = build.numel()
    b = int32_bits(build).to(torch.int64) & 0xFFFFFFFF
    p = int32_bits(keys).to(torch.int64) & 0xFFFFFFFF
    pos = torch.searchsorted(b, p, side="left")
    safe = pos.clamp(0, max(nb - 1, 0))
    return safe, ((pos < nb) & (b[safe] == p)).to(torch.int32)


def measure_probe(rng, results: dict) -> None:
    """join_probe against the route it replaced, each timing beside its bound."""
    for nb_label, nb in PROBE_BUILDS.items():
        build = probe_build(rng, nb)
        for label, n in SIZES.items():
            for share in PROBE_SHARES:
                live = int(n * share)
                for order in ("sorted", "random"):
                    keys = probe_keys(rng, n, live, build, order)
                    pos, keep = join_probe(keys, live, build)
                    safe, matched = replaced_probe(keys, build)
                    if not (torch.equal(pos[:live], safe[:live].to(torch.int32))
                            and torch.equal(keep[:live], matched[:live])):
                        raise SystemExit(f"probe {label} {share:.0%} {order} into {nb_label}: "
                                         "the kernel differs from the route it replaced")
                    del pos, keep, safe, matched
                    fns = {"kernel": lambda: join_probe(keys, live, build),
                           "parent": lambda: replaced_probe(keys, build)}
                    key = f"probe @ {label}, {share:.0%} live, {order}, into {nb_label}"
                    record(results, key, turns_of(fns, None),
                           bound_of(probe_bytes(n, live, nb), 0)[0] * 1e3, n, live)
                    del keys
                    torch.cuda.empty_cache()
        del build


def probe_variant(label: str, lines: tuple) -> ctypes.CDLL:
    """``csrc/join_probe.cu`` with the lines changed, built alone into ``build/kernels_ab/``."""
    text = (_build._CSRC / "join_probe.cu").read_text()
    for old, new in lines:
        if old not in text:
            raise SystemExit(f"variant {label}: {old!r} is not in join_probe.cu")
        text = text.replace(old, new)
    csrc = VARIANT_BUILD / "probe_src" / re.sub(r"\W+", "_", label)
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / "join_probe.cu").write_text(text)
    ptxas_report(f"variant {label}", csrc)
    lib = ctypes.CDLL(str(_build.build(csrc, VARIANT_BUILD)))
    lib.grs_join_probe.argtypes = _build._SIGNATURES["grs_join_probe"]
    lib.grs_join_probe.restype = ctypes.c_int
    return lib


def measure_probe_variants(rng, results: dict) -> None:
    """The port's join_probe beside builds with one constant changed, at the cells' probes."""
    libs = {label: probe_variant(label, lines) for label, lines in PROBE_VARIANTS.items()}
    for cell, n, live, nb, order in PROBE_CELLS:
        build = probe_build(rng, nb)
        keys = probe_keys(rng, n, live, build, order)
        want = join_probe(keys, live, build)
        pos, keep = torch.empty_like(want[0]), torch.empty_like(want[1])

        def variant(lib):
            def run():
                call(lib, "grs_join_probe", keys.data_ptr(), n, live, build.data_ptr(), nb,
                     pos.data_ptr(), keep.data_ptr(), 0)
            return run

        fns = {"port": lambda: join_probe(keys, live, build)}
        for label, lib in libs.items():
            pos.fill_(-7)
            keep.fill_(-7)
            variant(lib)()
            if not (torch.equal(pos, want[0]) and torch.equal(keep, want[1])):
                raise SystemExit(f"variant {label} at {cell}: differs from the port's kernel")
            fns[label] = variant(lib)
        record(results, f"probe variants @ {cell}", turns_of(fns, "join_probe_kernel"),
               bound_of(probe_bytes(n, live, nb), 0)[0] * 1e3, n, live)
        del build, keys, want, pos, keep
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=pathlib.Path, help="an older copy of csrc/ to time beside")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's register report")
    parser.add_argument("--gather", action="store_true",
                        help="time the payload gather instead of the fused sort's kernels")
    parser.add_argument("--probe", action="store_true",
                        help="time the join's probe and its tuning variants instead")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("FAIL no CUDA device")
        return 1
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    _build.library()
    old = old_library(args.old) if args.old else None
    results: dict = {"card": card}
    if args.ptxas:
        results["ptxas"] = {"new": ptxas_report("new", _build._CSRC)}
        if args.old:
            results["ptxas"]["old"] = ptxas_report("old", args.old)
    if args.gather:
        measure_gather(np.random.default_rng(SEED + 2), results)
    elif args.probe:
        measure_probe_variants(np.random.default_rng(SEED + 4), results)
        measure_probe(np.random.default_rng(SEED + 3), results)
    else:
        measure_all_live(np.random.default_rng(SEED), results, old)
        measure_live_shares(np.random.default_rng(SEED + 1), results, old)
    text = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(card, flush=True)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
