#!/usr/bin/env python3
"""Time the port's K1 (radix_hist) and K2 (bucketize) against an older build of them.

    python3 kernel_ab.py --old DIR [--ptxas] [--sweep] [--out FILE]

``DIR`` holds an older copy of ``gpuradixsort_tpu_torch/csrc`` (the C entry
points of the one-block-per-tile versions: ``grs_radix_hist`` without a
thread count, ``grs_bucketize`` with one thread per key of a chunk).  Both
builds are made with nvcc for sm_90a; the older one goes to
``build/kernels_old/``.  On one CUDA card, old and new take turns (old, new,
new, old) in:

1. each kernel's device time per pass (torch.profiler, 20 back-to-back
   calls, shift 0, radix 16 and, for K1, radix 256 and 2) at 1,000,000,
   2^24 and 100,000,000 keys (padded as the sorts pad them), beside its
   bound (bytes at 3.35 TB/s), each turn's output checked equal to the
   other build's;
2. the fused ``sort_pairs`` of 2^24 random keys (CUDA events, median of 7,
   and the profiler's device busy time), with the old kernels swapped into
   the sort;
3. ``sort_keys`` of the survivors of a 100,000,000-key filter (key < 2^31),
   as ``chip_smoke.py`` phase 6 runs it.

``--ptxas`` prints nvcc's register and spill report of both builds' K1 and
K2; ``--sweep`` times the new kernels at 1, 2, 4 and 8 tiles a block.  The
card's name and power limit and one JSON line of every number end the
output; ``--out`` also writes that JSON to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Table, int32_bits, make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import bucketize as bk
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.utils.timing import cuda_time_ms, profiled_device_ms

SEED = 20170101
HBM_PEAK_TBS = 3.35  # H100 SXM data sheet
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
OLD_BUILD = pathlib.Path(__file__).resolve().parent / "build" / "kernels_old"

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


class OldKernels:
    """K1 and K2 of an older build, behind the new wrappers' signatures."""

    def __init__(self, csrc: pathlib.Path):
        self.lib = ctypes.CDLL(str(_build.build(csrc, OLD_BUILD)))
        self.lib.grs_radix_hist.argtypes = [_P, _P, _I64, _I, _I, _I, _P]
        self.lib.grs_bucketize.argtypes = [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P]
        for fn in (self.lib.grs_radix_hist, self.lib.grs_bucketize):
            fn.restype = ctypes.c_int

    def _call(self, fn, *args) -> None:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {fn.__name__}: CUDA error {err}")

    def tile_histograms(self, keys, shift, cfg, impl=None):
        num_tiles = keys.numel() // cfg.tile
        hist = torch.empty((num_tiles, cfg.radix), dtype=torch.int32, device=keys.device)
        self._call(self.lib.grs_radix_hist, keys.data_ptr(), hist.data_ptr(), num_tiles,
                   cfg.tile, shift, cfg.radix)
        return hist

    def bucketize_tiles(self, keys, idx, shift, cfg, impl=None):
        out_keys, out_idx = torch.empty_like(keys), torch.empty_like(idx)
        self._call(self.lib.grs_bucketize, keys.data_ptr(), idx.data_ptr(), out_keys.data_ptr(),
                   out_idx.data_ptr(), keys.numel() // cfg.tile, cfg.tile,
                   rk.chunk_threads(cfg), shift, cfg.radix)
        return out_keys, out_idx


@contextlib.contextmanager
def kernels_of(side: str, old: OldKernels):
    """Inside the block the sorts run ``side``'s K1 and K2 ("old" or "new")."""
    if side == "new":
        yield
        return
    saved = rk.tile_histograms, sort_ops.bucketize_tiles
    rk.tile_histograms, sort_ops.bucketize_tiles = old.tile_histograms, old.bucketize_tiles
    try:
        yield
    finally:
        rk.tile_histograms, sort_ops.bucketize_tiles = saved


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return torch.equal(int32_bits(a), int32_bits(b))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def ptxas_report(csrc: pathlib.Path, label: str) -> None:
    for name in ("radix_hist.cu", "bucketize.cu"):
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", "/dev/null", str(csrc / name)],
                              capture_output=True, text=True, timeout=300)
        for line in (done.stdout + done.stderr).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {label} {name}: {line.strip()}")


def device_us(fn, calls: int = 20) -> float:
    return profiled_device_ms(fn, calls=calls)[0] * 1e3


def bound_us(nbytes: int) -> float:
    return nbytes / (HBM_PEAK_TBS * 1e12) * 1e6


def kernel_cases(keys, idx, old: OldKernels):
    """name: (old call, new call, bytes the function must move)."""
    cases = {}
    n = keys.numel()
    for bits in (4, 8, 1):
        cfg = EngineConfig(radix_bits=bits)
        tiles = n // cfg.tile
        cases[f"radix_hist radix {cfg.radix}"] = (
            lambda cfg=cfg: old.tile_histograms(keys, 0, cfg),
            lambda cfg=cfg: rk.tile_histograms(keys, 0, cfg),
            4 * n + 4 * cfg.radix * tiles)
    cfg = EngineConfig()
    cases["bucketize radix 16"] = (lambda: old.bucketize_tiles(keys, idx, 0, cfg),
                                   lambda: bk.bucketize_tiles(keys, idx, 0, cfg), 16 * n)
    return cases


def phase_kernels(old: OldKernels, rng, results: dict) -> None:
    cfg = EngineConfig()
    for label, n in SIZES.items():
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
        idx = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device).view(torch.uint32)
        for name, (old_fn, new_fn, nbytes) in kernel_cases(keys, idx, old).items():
            turns = {"old": [], "new": []}
            for side in ("old", "new", "new", "old"):
                fn = old_fn if side == "old" else new_fn
                turns[side].append(device_us(fn))
            if not same(old_fn(), new_fn()):
                raise SystemExit(f"{name} at {label}: old and new outputs differ")
            bound = bound_us(nbytes)
            row = {side: float(np.median(v)) for side, v in turns.items()}
            row.update(turns=turns, bound_us=bound, padded=keys.numel(),
                       share_old=bound / row["old"], share_new=bound / row["new"])
            results[f"{name} @ {label}"] = row
            log(f"{name} @ {label} ({keys.numel()} keys): device us per pass, turns "
                f"old {turns['old'][0]:.2f} new {turns['new'][0]:.2f} new {turns['new'][1]:.2f} "
                f"old {turns['old'][1]:.2f}; bound {bound:.2f} us; share of bound "
                f"old {row['share_old']:.3f} new {row['share_new']:.3f}")
        del keys, idx
        torch.cuda.empty_cache()


def sweep(rng, results: dict) -> None:
    """The new kernels at 1, 2, 4 and 8 tiles a block (device us per pass)."""
    for label, n in SIZES.items():
        cfg = EngineConfig()
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
        idx = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device).view(torch.uint32)
        num_tiles = keys.numel() // cfg.tile
        out = [torch.empty_like(keys), torch.empty_like(idx)]
        for per_block in (1, 2, 4, 8):
            threads = 32 * per_block
            for bits in (4, 8):
                kcfg = EngineConfig(radix_bits=bits)
                hist = torch.empty((num_tiles, kcfg.radix), dtype=torch.int32, device=keys.device)
                us = device_us(lambda: _build.launch(
                    "grs_radix_hist", keys, keys.data_ptr(), hist.data_ptr(), num_tiles,
                    kcfg.tile, threads, 0, kcfg.radix))
                results[f"sweep radix_hist radix {kcfg.radix} {per_block} tiles/block @ {label}"] = us
                log(f"sweep radix_hist radix {kcfg.radix} @ {label}: {per_block} tiles a block "
                    f"{us:.2f} us")
            us = device_us(lambda: _build.launch(
                "grs_bucketize", keys, keys.data_ptr(), idx.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), num_tiles, cfg.tile, threads, 0, cfg.radix))
            results[f"sweep bucketize {per_block} tiles/block @ {label}"] = us
            log(f"sweep bucketize @ {label}: {per_block} tiles a block {us:.2f} us")
        del keys, idx, out
        torch.cuda.empty_cache()


def ab_sorts(old: OldKernels, rng, results: dict) -> None:
    cfg = EngineConfig()
    col = make_key_column(rng.integers(0, 2**32, 1 << 24, dtype=np.uint32), cfg)
    fkeys = make_key_column(rng.integers(0, 2**32, 100_000_000, dtype=np.uint32), cfg)
    kept = filter_table(Table({"key": fkeys}), lambda t: int32_bits(t["key"].data) >= 0,
                        cfg).to_table()["key"]
    del fkeys
    torch.cuda.empty_cache()
    cases = {
        "sort_pairs fused 2^24": lambda: sort_ops.sort_pairs(col, cfg, method="fused"),
        f"sort_keys of the {kept.length} survivors of a 100M filter": (
            lambda: sort_ops.sort_keys(kept, cfg)),
    }
    for name, fn in cases.items():
        outs, turns, busy = {}, {"old": [], "new": []}, {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            with kernels_of(side, old):
                outs[side] = fn()
                turns[side].append(float(np.median(cuda_time_ms(fn, reps=7, warmup=1))))
                busy[side].append(profiled_device_ms(fn, calls=3)[0])
        got = [(c.data,) if not isinstance(c, tuple) else tuple(x.data for x in c)
               for c in (outs["old"], outs["new"])]
        if not same(*got):
            raise SystemExit(f"{name}: old and new kernels sort differently")
        row = {"event_ms": turns, "busy_ms": busy,
               "old": float(np.median(turns["old"])), "new": float(np.median(turns["new"]))}
        results[name] = row
        log(f"{name}: CUDA events ms (median of 7), turns old {turns['old'][0]:.4f} new "
            f"{turns['new'][0]:.4f} new {turns['new'][1]:.4f} old {turns['old'][1]:.4f}; "
            f"device busy ms old {busy['old'][0]:.4f} new {busy['new'][0]:.4f} "
            f"new {busy['new'][1]:.4f} old {busy['old'][1]:.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, type=pathlib.Path,
                        help="directory of the older csrc sources")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's register report")
    parser.add_argument("--sweep", action="store_true", help="time 1-8 tiles a block")
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
    ab_sorts(old, rng, results)
    text = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(card, flush=True)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
