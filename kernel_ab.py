#!/usr/bin/env python3
"""Time the fused pass's kernel (bucketize_scatter) at each block size, beside K2 then K3.

    python3 kernel_ab.py [--old DIR] [--ptxas] [--out FILE]

``csrc/bucketize_scatter.cu`` gives each warp one tile; the wrapper puts
``FUSED_TILES_PER_BLOCK`` tiles in a block.  On one CUDA card, device time
per call (torch.profiler, 20 back-to-back calls) on one radix-16 pass's
input (random keys, their index, K1's histograms and offsets) at
1,000,000, 2^24 and 100,000,000 keys (padded as the sorts pad them): the
port's build at 8, 4 and 2 tiles a block, and K2 then K3 on the same
input, in mirrored turns, every output checked equal to the plain version;
beside the bound (16 bytes a key and the offsets table at 3.35 TB/s).
``--old DIR`` adds an older copy of ``csrc/`` (built the same way into
``build/kernels_old/``), whose ``grs_bucketize_scatter`` has this one's C
signature, at the wrapper's tiles a block to the same turns.

``--ptxas`` prints nvcc's register and spill report of each kernel of the
source (and of the older one).  The card's name and power limit and one
JSON line of every number end the output; ``--out`` also writes that JSON
to a file.  The A/B of this kernel
against its persistent and ``-maxrregcount=128`` builds is ``kernel_ab.py``
of commit 28b5419; K3's against its first design that of commit 6fc2579;
K4's and K5's that of commit 17e53c9.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from gpuradixsort_tpu_torch.bench import stage_work
from gpuradixsort_tpu_torch.config import PAD_INDEX, EngineConfig
from gpuradixsort_tpu_torch.core.table import int32_bits, make_key_column, pad_to_tile
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels import scatter as scatter_kernels
from gpuradixsort_tpu_torch.kernels.bucketize import bucketize_tiles
from gpuradixsort_tpu_torch.utils.timing import HBM_PEAK_TBS, card_line, profiled_device_ms

SEED = 20170101
OLD_BUILD = pathlib.Path(__file__).resolve().parent / "build" / "kernels_old"
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
TILES_A_BLOCK = (8, 4, 2)


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


def fused_pass(keys, idx, offsets, cfg: EngineConfig, tiles: int, lib=None):
    """``lib``'s (by default the port's) ``grs_bucketize_scatter`` at ``tiles`` tiles a block.

    Into a fresh output, unplanned.
    """
    out = (torch.empty_like(keys), torch.empty_like(idx))
    err = (lib or _build.library()).grs_bucketize_scatter(
        keys.data_ptr(), idx.data_ptr(), offsets.data_ptr(), *map(rk.data_ptr, out), None, None,
        keys.numel() // cfg.tile, cfg.tile, 32 * tiles, 0, cfg.radix, None, 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grs_bucketize_scatter: CUDA error {err}")
    return out


def same(a, b) -> bool:
    return all(torch.equal(int32_bits(x), int32_bits(y)) for x, y in zip(a, b, strict=True))


def old_library(csrc: pathlib.Path) -> ctypes.CDLL:
    """The older ``csrc/`` built alone, its ``grs_bucketize_scatter`` typed as the port's."""
    lib = ctypes.CDLL(str(_build.build(csrc, OLD_BUILD)))
    lib.grs_bucketize_scatter.argtypes = _build._SIGNATURES["grs_bucketize_scatter"]
    lib.grs_bucketize_scatter.restype = ctypes.c_int
    return lib


def ptxas_report(label: str, csrc: pathlib.Path) -> None:
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           "/dev/null", str(csrc / "bucketize_scatter.cu")],
                          capture_output=True, text=True, timeout=300)
    for line in (done.stdout + done.stderr).splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "error")):
            log(f"ptxas {label}: {line.strip()}")


def device_us(fn, calls: int = 20) -> float:
    """Device µs per call from the profiler; 0.0 where it recorded no whole profile."""
    return profiled_device_ms(fn, calls=calls)[0] * 1e3


def fmt(x: float, digits: int = 2) -> str:
    return f"{x:.{digits}f}" if x else "not measured"


def pass_input(rng, n: int, cfg: EngineConfig):
    """One radix-16 pass's input at n keys: (keys, idx, hist, offsets)."""
    keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
    idx = pad_to_tile(torch.arange(n, dtype=torch.int32, device=keys.device).view(torch.uint32),
                      cfg, PAD_INDEX)
    hist = rk.tile_histograms(keys, 0, cfg)
    return keys, idx, hist, rk.global_offsets(hist)


def measure(rng, results: dict, old: ctypes.CDLL | None) -> None:
    cfg = EngineConfig()
    tiles = scatter_kernels.FUSED_TILES_PER_BLOCK
    for label, n in SIZES.items():
        keys, idx, hist, offsets = pass_input(rng, n, cfg)
        want = scatter_kernels.bucketize_scatter(keys, idx, hist, offsets, 0, cfg,
                                                 impl="reference")
        sides = {f"{t}/block": (lambda t=t: fused_pass(keys, idx, offsets, cfg, t))
                 for t in TILES_A_BLOCK}
        if old is not None:
            sides[f"old {tiles}/block"] = lambda: fused_pass(keys, idx, offsets, cfg, tiles, old)
        for name, fn in sides.items():
            if not same(fn(), want):
                raise SystemExit(f"bucketize_scatter {label} {name}: differs from the plain version")
        del want
        sides["K2 then K3"] = lambda: scatter_kernels.scatter_runs(
            *bucketize_tiles(keys, idx, 0, cfg), hist, offsets, cfg)
        turns = {name: [] for name in sides}
        for name in list(sides) + list(sides)[::-1]:  # mirrored turns
            turns[name].append(device_us(sides[name]))
        row = {name: float(np.median([t for t in ts if t] or [0.0])) for name, ts in turns.items()}
        bound = stage_work(keys.numel(), cfg)["bucketize_scatter"][0] / (HBM_PEAK_TBS * 1e12) * 1e6
        results[f"bucketize_scatter @ {label}"] = {**row, "turns": turns, "bound_us": bound,
                                                   "padded": keys.numel()}
        log(f"bucketize_scatter radix 16 @ {label} ({keys.numel()} keys): device us per call, "
            f"median of 2 mirrored turns: " + ", ".join(
                f"{k} {fmt(v)} (share of bound {fmt(bound / v if v else 0, 3)})"
                for k, v in row.items()) + f"; bound {bound:.2f} us")
        del keys, idx, hist, offsets, sides
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=pathlib.Path, help="an older copy of csrc/ to time beside")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's register report")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("FAIL no CUDA device")
        return 1
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    _build.library()
    old = old_library(args.old) if args.old else None
    if args.ptxas:
        ptxas_report("port", _build._CSRC)
        if args.old:
            ptxas_report("old", args.old)
    results: dict = {"card": card}
    measure(np.random.default_rng(SEED), results, old)
    text = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(card, flush=True)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
