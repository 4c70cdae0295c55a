#!/usr/bin/env python3
"""Time the port's K4 (radix_dest) and K5 (exclusive_scan) against an older build of them.

    python3 kernel_ab.py --old DIR [--ptxas] [--sweep] [--out FILE]

``DIR`` holds an older copy of ``gpuradixsort_tpu_torch/csrc`` with the C
entry points of the designs before the one-warp-a-tile K4 and the one-pass
K5: ``grs_radix_dest`` with one thread per key of a chunk, and
``grs_exclusive_scan(x, out, n, num_blocks)`` in three launches over chunks
of 4,096.  Both builds are made with nvcc for sm_90a; the older one goes to
``build/kernels_old/``.  On one CUDA card, old and new take turns (old, new,
new, old) in:

1. each kernel's device time per call (torch.profiler, 20 back-to-back
   calls) at 1,000,000, 2^24 and 100,000,000 keys (padded as the sorts pad
   them), beside its bound (bytes at 3.35 TB/s), each turn's output checked
   equal to the other build's: K4 at radix 2, 16 and 256 (shift 0); K5 on
   a length-N int32 vector, with ``torch.cumsum`` of it timed in the same
   turns, and on one pass's offsets table read in (digit, tile) order, as
   ``global_offsets`` scans it;
2. with the old kernels swapped into the operators (CUDA events, median of
   7, and the profiler's device busy time): ``sort_pairs`` by the radix
   method of 2^24 random keys, ``filter_table`` of 100,000,000 keys keeping
   key < 2^31, and ``join_expand`` of a 10,000,000-row probe against
   10,000,000 build rows over 5,000,000 keys.

``--ptxas`` prints nvcc's register and spill report of both builds' K4 and
K5.  ``--sweep`` first times the choices behind the new K5 and K4, each
output checked equal to the plain version: K5 as the port builds it (chunks
of 8,192, relaxed status words, the memset's own time split out) beside
builds of ``csrc/scan.cu`` alone with chunks of 4,096 and 16,384
(``GRS_SCAN_WARPS``) and with acquire and release status words
(``GRS_SCAN_ACQUIRE_RELEASE``), and beside ``trials/scan_one_block.cu`` (one
block, no look-back) up to 2^21 elements, in mirrored turns, from one chunk
to 100M elements; then the new K4 at 1, 2, 4 and 8 tiles a block.  The
card's name and power limit and one JSON line of every number end the
output; ``--out`` also writes that JSON to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Table, int32_bits, make_column, make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels import scan as sk
from gpuradixsort_tpu_torch.ops import join as join_ops
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.utils.timing import cuda_time_ms, profiled_device_ms

SEED = 20170101
HBM_PEAK_TBS = 3.35  # H100 SXM data sheet
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
ROOT = pathlib.Path(__file__).resolve().parent
OLD_BUILD = ROOT / "build" / "kernels_old"
SWEEP_BUILD = ROOT / "build" / "kernels_sweep"
ONE_BLOCK_MAX = 1 << 21  # the one-block trial scans serially; longer inputs only take time
OLD_SCAN_CHUNK = 4096

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


class OldKernels:
    """K4 and K5 of an older build, behind the new wrappers' signatures."""

    def __init__(self, csrc: pathlib.Path):
        self.lib = ctypes.CDLL(str(_build.build(csrc, OLD_BUILD)))
        self.lib.grs_radix_dest.argtypes = [_P, _P, _P, _I64, _I, _I, _I, _I, _P]
        self.lib.grs_exclusive_scan.argtypes = [_P, _P, _I64, _I64, _P]
        for fn in (self.lib.grs_radix_dest, self.lib.grs_exclusive_scan):
            fn.restype = ctypes.c_int

    def _call(self, fn, *args) -> None:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {fn.__name__}: CUDA error {err}")

    def tile_destinations(self, keys, offsets, shift, cfg, impl=None):
        dest = torch.empty(keys.numel(), dtype=torch.int32, device=keys.device)
        threads = 128 * math.gcd(cfg.tile_rows, 4)  # one thread per key of a chunk
        self._call(self.lib.grs_radix_dest, keys.data_ptr(), offsets.data_ptr(),
                   dest.data_ptr(), keys.numel() // cfg.tile, cfg.tile, threads, shift,
                   cfg.radix)
        return dest

    def exclusive_scan(self, x, impl=None):
        x = x.to(torch.int32).contiguous()
        n = x.numel()
        num_blocks = -(-n // OLD_SCAN_CHUNK)
        out = torch.empty(n + num_blocks + 1, dtype=torch.int32, device=x.device)
        self._call(self.lib.grs_exclusive_scan, x.data_ptr(), out.data_ptr(), n, num_blocks)
        return out[:n], out[-1]


@contextlib.contextmanager
def kernels_of(side: str, old: OldKernels):
    """Inside the block the operators run ``side``'s K4 and K5 ("old" or "new")."""
    if side == "new":
        yield
        return
    saved = rk.tile_destinations, rk.exclusive_scan, join_ops.exclusive_scan
    rk.tile_destinations = old.tile_destinations
    rk.exclusive_scan = join_ops.exclusive_scan = old.exclusive_scan
    try:
        yield
    finally:
        rk.tile_destinations, rk.exclusive_scan, join_ops.exclusive_scan = saved


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return torch.equal(int32_bits(a), int32_bits(b))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def ptxas_report(csrc: pathlib.Path, label: str) -> None:
    for name in ("radix_dest.cu", "scan.cu"):
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", "/dev/null", str(csrc / name)],
                              capture_output=True, text=True, timeout=300)
        for line in (done.stdout + done.stderr).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {label} {name}: {line.strip()}")


def device_us(fn, calls: int = 20) -> float:
    """Device µs per call from the profiler; 0.0 where it recorded no whole profile."""
    return profiled_device_ms(fn, calls=calls)[0] * 1e3


def median_measured(turns: list[float]) -> float:
    """The median of the turns the profiler measured, else 0.0 (not measured)."""
    return float(np.median([t for t in turns if t] or [0.0]))


def fmt(x: float, digits: int = 2) -> str:
    return f"{x:.{digits}f}" if x else "not measured"


def share(bound: float, measured: float) -> float | None:
    return bound / measured if measured else None


def bound_us(nbytes: int) -> float:
    return nbytes / (HBM_PEAK_TBS * 1e12) * 1e6


def kernel_cases(keys, rng, old: OldKernels):
    """name: (old call, new call, library call or None, bytes the function must move)."""
    cases = {}
    n = keys.numel()
    for bits in (1, 4, 8):
        cfg = EngineConfig(radix_bits=bits)
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        cases[f"radix_dest radix {cfg.radix}"] = (
            lambda cfg=cfg, o=offsets: old.tile_destinations(keys, o, 0, cfg),
            lambda cfg=cfg, o=offsets: rk.tile_destinations(keys, o, 0, cfg),
            None, 8 * n + 4 * offsets.numel())
        if bits == 4:
            by_digit = hist.t().contiguous().view(-1)
            cases["exclusive_scan offsets"] = (
                lambda: old.exclusive_scan(by_digit), lambda: sk.exclusive_scan(by_digit),
                None, 8 * by_digit.numel() + 4)
    counts = torch.from_numpy(rng.integers(0, 100, n, dtype=np.int32)).to(keys.device)
    cases["exclusive_scan vector"] = (
        lambda: old.exclusive_scan(counts), lambda: sk.exclusive_scan(counts),
        lambda: torch.cumsum(counts, 0, dtype=torch.int32), 8 * n + 4)
    return cases


def phase_kernels(old: OldKernels, rng, results: dict) -> None:
    cfg = EngineConfig()
    for label, n in SIZES.items():
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
        for name, (old_fn, new_fn, lib_fn, nbytes) in kernel_cases(keys, rng, old).items():
            turns = {"old": [], "new": [], "library": []}
            for side in ("old", "new", "new", "old"):
                turns[side].append(device_us(old_fn if side == "old" else new_fn))
                if lib_fn is not None:
                    turns["library"].append(device_us(lib_fn))
            if not same(old_fn(), new_fn()):
                raise SystemExit(f"{name} at {label}: old and new outputs differ")
            bound = bound_us(nbytes)
            row = {side: median_measured(v) for side, v in turns.items() if v}
            row.update(turns=turns, bound_us=bound, padded=keys.numel(),
                       share_old=share(bound, row["old"]), share_new=share(bound, row["new"]))
            results[f"{name} @ {label}"] = row
            lib = (f"; torch.cumsum turns {', '.join(fmt(t) for t in turns['library'])}"
                   if lib_fn is not None else "")
            log(f"{name} @ {label} ({keys.numel()} keys, {nbytes / 1e6:.2f} MB): device us "
                f"per call, turns old {fmt(turns['old'][0])} new {fmt(turns['new'][0])} "
                f"new {fmt(turns['new'][1])} old {fmt(turns['old'][1])}{lib}; bound {bound:.2f} "
                f"us; share of bound old {fmt(row['share_old'] or 0, 3)} new "
                f"{fmt(row['share_new'] or 0, 3)}")
        del keys
        torch.cuda.empty_cache()


class ScanBuilds:
    """Builds of K5 under trial, each behind the wrapper's allocation: name -> (x -> (scan, total))."""

    def __init__(self):
        flags = {"chunk 4096": ["-DGRS_SCAN_WARPS=4"], "chunk 16384": ["-DGRS_SCAN_WARPS=16"],
                 "acquire/release": ["-DGRS_SCAN_ACQUIRE_RELEASE"]}
        chunks = {"chunk 4096": 4096, "chunk 16384": 16384, "acquire/release": sk.CHUNK}
        sources = {name: _build._CSRC / "scan.cu" for name in flags}
        sources["one block"] = ROOT / "trials" / "scan_one_block.cu"
        flags["one block"] = []
        SWEEP_BUILD.mkdir(parents=True, exist_ok=True)
        libs = {name: SWEEP_BUILD / f"{name.replace(' ', '_').replace('/', '_')}.so"
                for name in sources}
        _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, *flags[name], "-shared", "-o",
                          str(libs[name]), str(sources[name])] for name in sources])
        self.calls = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            if name == "one block":
                fn = lib.grs_exclusive_scan_one_block
                fn.argtypes = [_P, _P, _I64, _P]
            else:
                fn = lib.grs_exclusive_scan
                fn.argtypes = [_P, _P, _I64, _I, _P, _P]
            fn.restype = ctypes.c_int
            self.calls[name] = self._scan(fn, chunks.get(name))

    @staticmethod
    def _scan(fn, chunk):
        def run(x):
            n = x.numel()
            head = (n + 2) // 2 * 2
            words = -(-n // chunk) + 1 if chunk else 0
            out = torch.empty(head + 2 * words, dtype=torch.int32, device=x.device)
            args = (x.data_ptr(), out.data_ptr(), n) + (
                (chunk, out[head:].data_ptr()) if chunk else ())
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
            return out[:n], out[n]
        return run


def sweep(rng, results: dict) -> None:
    """The new K5 beside its trial builds, then the new K4 at 1-8 tiles a block."""
    dev = torch.device("cuda", 0)
    builds = ScanBuilds()
    lengths = {"8192": 8192, "16384": 16384, "32768": 32768, "131072": 131072,
               "offsets 1M": 15744, "offsets 2^24": 262144, "offsets 100M": 1562624,
               **SIZES}
    for label, n in lengths.items():
        x = torch.from_numpy(rng.integers(0, 100, n, dtype=np.int32)).to(dev)
        want = sk.exclusive_scan(x, impl="reference")
        sides = {"port": lambda: sk.exclusive_scan(x)}
        sides.update({name: (lambda call=call: call(x)) for name, call in builds.calls.items()
                      if name != "one block" or n <= ONE_BLOCK_MAX})
        for name, fn in sides.items():
            if not same(fn(), want):
                raise SystemExit(f"scan sweep {label} {name}: differs from the plain version")
        order = list(sides) + list(sides)[::-1]  # mirrored turns
        turns = {name: [] for name in sides}
        split = {}
        for name in order:
            us, rows = profiled_device_ms(sides[name], calls=20)
            turns[name].append(us * 1e3)
            if name == "port" and rows:
                split = {row: ms * 1e3 for row, ms in rows.items()}
        row = {name: median_measured(t) for name, t in turns.items()}
        results[f"sweep exclusive_scan {label}"] = {**row, "turns": turns, "port rows": split}
        log(f"sweep exclusive_scan {label} ({n}): device us per call, median of 2 mirrored "
            f"turns: " + ", ".join(f"{name} {fmt(us)}" for name, us in row.items())
            + "; port's rows: " + ", ".join(f"{k[:40]} {v:.2f}" for k, v in split.items()))
        del x
    for label, n in SIZES.items():
        cfg = EngineConfig()
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
        num_tiles = keys.numel() // cfg.tile
        dest = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
        for bits in (1, 4, 8):
            kcfg = EngineConfig(radix_bits=bits)
            offsets = rk.global_offsets(rk.tile_histograms(keys, 0, kcfg))
            for per_block in (1, 2, 4, 8):
                us = device_us(lambda: _build.launch(
                    "grs_radix_dest", keys, keys.data_ptr(), offsets.data_ptr(), dest.data_ptr(),
                    num_tiles, kcfg.tile, 32 * per_block, 0, kcfg.radix))
                results[f"sweep radix_dest radix {kcfg.radix} {per_block} tiles/block @ {label}"] = us
                log(f"sweep radix_dest radix {kcfg.radix} @ {label}: {per_block} tiles a block "
                    f"{fmt(us)} us")
        del keys, dest
        torch.cuda.empty_cache()


def join_expand_inputs(rng, cfg):
    """10M probe rows and 10M build rows over 5M keys: about two copies of each key."""
    n, keys = 10_000_000, 5_000_000
    pool = np.unique(rng.integers(0, 2**32, keys * 5 // 4, dtype=np.uint32))
    pool = np.sort(rng.permutation(pool)[:keys])

    def table(key, vname, gid):
        t = Table({vname: make_column(rng.integers(0, 2**31 - 1, n, dtype=np.int32), cfg)})
        return t.with_column(key, make_key_column(pool[gid], cfg))

    pgid, bgid = rng.integers(0, pool.size, n), rng.integers(0, pool.size, n)
    probe, build = table("k", "pv", pgid), table("k", "bv", bgid)
    return probe, build, int(np.bincount(bgid, minlength=pool.size)[pgid].sum())


def ab_ops(old: OldKernels, rng, results: dict) -> None:
    cfg = EngineConfig()
    col = make_key_column(rng.integers(0, 2**32, 1 << 24, dtype=np.uint32), cfg)
    fkeys = Table({"key": make_key_column(rng.integers(0, 2**32, 100_000_000, dtype=np.uint32),
                                          cfg)})
    probe, build, capacity = join_expand_inputs(rng, cfg)
    torch.cuda.synchronize()

    def outputs(table):
        return [table[name].data for name in table.names()]

    cases = {
        "sort_pairs radix 2^24": lambda: [c.data for c in
                                          sort_ops.sort_pairs(col, cfg, method="radix")],
        "filter_table + to_table, 100M keys, key < 2^31": lambda: outputs(filter_table(
            fkeys, lambda t: int32_bits(t["key"].data) >= 0, cfg).to_table()),
        "join_expand + to_table, 10M x 10M, ~2 copies a key": lambda: outputs(
            join_ops.join_expand(probe, build, "k", cfg, capacity=capacity).to_table()),
    }
    for name, fn in cases.items():
        outs, turns, busy = {}, {"old": [], "new": []}, {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            with kernels_of(side, old):
                outs[side] = fn()
                turns[side].append(float(np.median(cuda_time_ms(fn, reps=7, warmup=1))))
                busy[side].append(profiled_device_ms(fn, calls=3)[0])
        if not same(outs["old"], outs["new"]):
            raise SystemExit(f"{name}: old and new kernels give different results")
        results[name] = {"event_ms": turns, "busy_ms": busy,
                         "old": float(np.median(turns["old"])),
                         "new": float(np.median(turns["new"]))}
        log(f"{name}: CUDA events ms (median of 7), turns old {turns['old'][0]:.4f} new "
            f"{turns['new'][0]:.4f} new {turns['new'][1]:.4f} old {turns['old'][1]:.4f}; "
            f"device busy ms old {fmt(busy['old'][0], 4)} new {fmt(busy['new'][0], 4)} "
            f"new {fmt(busy['new'][1], 4)} old {fmt(busy['old'][1], 4)}")
        del outs
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, type=pathlib.Path,
                        help="directory of the older csrc sources")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's register report")
    parser.add_argument("--sweep", action="store_true",
                        help="time K5's trial builds and K4's tiles a block first")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("FAIL no CUDA device")
        return 1
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    _build.library()
    old = OldKernels(args.old)
    if args.ptxas:
        ptxas_report(_build._CSRC, "new")
        ptxas_report(args.old, "old")
    rng = np.random.default_rng(SEED)
    results: dict = {"card": card}
    if args.sweep:
        sweep(rng, results)
    phase_kernels(old, rng, results)
    ab_ops(old, rng, results)
    text = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(card, flush=True)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
