#!/usr/bin/env python3
"""Time the port's K3 (scatter_runs) against an older build of it.

    python3 kernel_ab.py --old DIR [--ptxas] [--sweep] [--out FILE]

``DIR`` holds an older copy of ``gpuradixsort_tpu_torch/csrc/scatter_runs.cu``
(and, if wanted, the rest of that ``csrc/``) whose ``grs_scatter_runs`` has
the C signature from before the fused sort's pass plan, such as the
one-block-a-tile design of commit 17e53c9.
Both builds are made with nvcc for sm_90a; the older one goes to
``build/kernels_old/``.  On one CUDA card, old and new take turns (old, new,
new, old) in:

1. K3's device time per call (torch.profiler, 20 back-to-back calls) on one
   radix-16 pass's input (keys bucketized by the port's K2, their
   histograms and offsets) at 1,000,000, 2^24 and 100,000,000 keys (padded
   as the sorts pad them), beside its bound (16 bytes a key and the two
   tables at 3.35 TB/s) and a device-to-device copy of the same keys and
   indices (two ``copy_``, the same 16 bytes a key, timed in the same
   turns), each turn's output checked equal to the other build's;
2. with the old K3 swapped into the fused sort's eager loop (CUDA events,
   median of 7, and the profiler's device busy time): the sort of 2^24
   random keys, and of the survivors of ``filter_table`` of 100,000,000 keys
   keeping key < 2^31 (a 100M padded buffer, as the smoke's phase 6 sorts).
   ``sort_pairs`` with ``GRAPH_MAX_PADDED`` patched to 0, so that its passes
   run by the eager loop: a cached CUDA graph would replay the K3 it
   captured first on both sides.  The old K3 knows no pass plan and runs
   every pass it is called for, so both inputs are checked to have every
   digit varying, where the plan runs every pass too.

``--ptxas`` prints nvcc's register and spill report of both builds' K3 and
of the new one's cp.async route.  ``--sweep`` first times builds of
``csrc/scatter_runs.cu`` alone: the register route and the cp.async route
(``GRS_SCATTER_CP_ASYNC``), each at 2, 4 and 8 tiles a block
(``GRS_SCATTER_WARPS``), beside the port's own build, in
mirrored turns at the three sizes, every output checked equal to the plain
version.  The card's name and power limit and one JSON line of every number
end the output; ``--out`` also writes that JSON to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, EngineConfig
from gpuradixsort_tpu_torch.core.table import Table, int32_bits, make_key_column, pad_to_tile
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels.bucketize import bucketize_tiles
from gpuradixsort_tpu_torch.kernels.key_bits import pass_mask
from gpuradixsort_tpu_torch.kernels.scatter import scatter_runs
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.sort import sort_pairs
from gpuradixsort_tpu_torch.utils.timing import (
    HBM_PEAK_TBS,
    card_line,
    cuda_time_ms,
    profiled_device_ms,
)

SEED = 20170101
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
ROOT = pathlib.Path(__file__).resolve().parent
OLD_BUILD = ROOT / "build" / "kernels_old"
SWEEP_BUILD = ROOT / "build" / "kernels_sweep"
SOURCE = _build._CSRC / "scatter_runs.cu"
# name: nvcc flags of a trial build of scatter_runs.cu: each route at 2, 4
# and 8 tiles a block.
ROUTES = {"register": [], "cp.async": ["-DGRS_SCATTER_CP_ASYNC"]}
SWEEP = {f"{route} {warps}/block": [*flags, f"-DGRS_SCATTER_WARPS={warps}"]
         for route, flags in ROUTES.items() for warps in (2, 4, 8)}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


class ScatterBuild:
    """``grs_scatter_runs`` of one build, behind ``scatter_runs``' signature.

    ``planned``: the build takes the fused sort's pass plan, as this tree's
    source does.  An older build does not: it writes the result buffer in
    every pass it is called for.
    """

    def __init__(self, path: pathlib.Path, planned: bool):
        self.fn = ctypes.CDLL(str(path)).grs_scatter_runs
        self.fn.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I, _I, *([_P, _I] * planned), _P]
        self.fn.restype = ctypes.c_int
        self.planned = planned

    def __call__(self, bk, bi, hist, offsets, cfg, impl=None, plan=None, pass_index=0,
                 result=None):
        out_keys, out_idx = result or (torch.empty_like(bk), torch.empty_like(bi))
        route = [rk.data_ptr(plan), pass_index] if self.planned else []
        err = self.fn(bk.data_ptr(), bi.data_ptr(), hist.data_ptr(), offsets.data_ptr(),
                      out_keys.data_ptr(), out_idx.data_ptr(), bk.numel() // cfg.tile,
                      cfg.tile, cfg.radix, *route, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"grs_scatter_runs: CUDA error {err}")
        return out_keys, out_idx, False


@contextlib.contextmanager
def scatter_of(side: str, old: ScatterBuild):
    """Inside the block the fused sort's eager loop runs ``side``'s K3 ("old" or "new")."""
    if side == "new":
        yield
        return
    sort_ops.scatter_runs = old
    try:
        yield
    finally:
        sort_ops.scatter_runs = scatter_runs


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return torch.equal(int32_bits(a), int32_bits(b))


def ptxas_report(src: pathlib.Path, label: str, flags=()) -> None:
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c",
                           "-o", "/dev/null", str(src)], capture_output=True, text=True, timeout=300)
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"ptxas {label}: {line.strip()}")


def device_us(fn, calls: int = 20) -> float:
    """Device µs per call from the profiler; 0.0 where it recorded no whole profile."""
    return profiled_device_ms(fn, calls=calls)[0] * 1e3


def median_measured(turns: list[float]) -> float:
    """The median of the turns the profiler measured, else 0.0 (not measured)."""
    return float(np.median([t for t in turns if t] or [0.0]))


def fmt(x: float, digits: int = 2) -> str:
    return f"{x:.{digits}f}" if x else "not measured"


def pass_input(rng, n: int, cfg: EngineConfig):
    """One radix-16 pass's K3 input at n keys: (bk, bi, hist, offsets)."""
    keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), cfg).data
    idx = pad_to_tile(torch.arange(n, dtype=torch.int32, device=keys.device).view(torch.uint32),
                      cfg, PAD_INDEX)
    hist = rk.tile_histograms(keys, 0, cfg)
    bk, bi = bucketize_tiles(keys, idx, 0, cfg)
    return bk, bi, hist, rk.global_offsets(hist)


def bound_us(bk: torch.Tensor, hist: torch.Tensor) -> float:
    return (16 * bk.numel() + 8 * hist.numel()) / (HBM_PEAK_TBS * 1e12) * 1e6


def phase_kernel(old: ScatterBuild, rng, results: dict) -> None:
    cfg = EngineConfig()
    for label, n in SIZES.items():
        bk, bi, hist, offsets = pass_input(rng, n, cfg)
        ck, ci = torch.empty_like(bk), torch.empty_like(bi)
        fns = {"old": lambda: old(bk, bi, hist, offsets, cfg),
               "new": lambda: scatter_runs(bk, bi, hist, offsets, cfg)}
        turns = {"old": [], "new": [], "copy": []}
        for side in ("old", "new", "new", "old"):
            turns[side].append(device_us(fns[side]))
            turns["copy"].append(device_us(lambda: (ck.copy_(bk), ci.copy_(bi))))
        if not same(fns["old"]()[:2], fns["new"]()[:2]):
            raise SystemExit(f"scatter_runs at {label}: old and new outputs differ")
        bound = bound_us(bk, hist)
        row = {side: median_measured(v) for side, v in turns.items()}
        row.update(turns=turns, bound_us=bound, padded=bk.numel(),
                   share_old=bound / row["old"] if row["old"] else None,
                   share_new=bound / row["new"] if row["new"] else None)
        results[f"scatter_runs @ {label}"] = row
        log(f"scatter_runs radix 16 @ {label} ({bk.numel()} keys): device us per call, turns "
            f"old {fmt(turns['old'][0])} new {fmt(turns['new'][0])} new {fmt(turns['new'][1])} "
            f"old {fmt(turns['old'][1])}; copy of the same bytes {fmt(row['copy'])}; "
            f"bound {bound:.2f} us; share of bound old "
            f"{fmt(row['share_old'] or 0, 3)} new {fmt(row['share_new'] or 0, 3)}")
        del bk, bi, hist, offsets, fns, ck, ci
        torch.cuda.empty_cache()


def sweep(rng, results: dict) -> None:
    """The port's K3 beside trial builds of its routes and tiles a block."""
    SWEEP_BUILD.mkdir(parents=True, exist_ok=True)
    libs = {name: SWEEP_BUILD / f"scatter_{name.replace(' ', '_').replace('/', '_')}.so"
            for name in SWEEP}
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, *SWEEP[name], "-shared", "-o",
                      str(libs[name]), str(SOURCE)] for name in SWEEP])
    builds = {name: ScatterBuild(path, planned=True) for name, path in libs.items()}
    cfg = EngineConfig()
    for label, n in SIZES.items():
        bk, bi, hist, offsets = pass_input(rng, n, cfg)
        want = scatter_runs(bk, bi, hist, offsets, cfg, impl="reference")[:2]
        sides = {"port": lambda: scatter_runs(bk, bi, hist, offsets, cfg)}
        sides.update({name: (lambda b=b: b(bk, bi, hist, offsets, cfg))
                      for name, b in builds.items()})
        for name, fn in sides.items():
            if not same(fn()[:2], want):
                raise SystemExit(f"scatter sweep {label} {name}: differs from the plain version")
        del want
        turns = {name: [] for name in sides}
        for name in list(sides) + list(sides)[::-1]:  # mirrored turns
            turns[name].append(device_us(sides[name]))
        row = {name: median_measured(t) for name, t in turns.items()}
        results[f"sweep scatter_runs @ {label}"] = {**row, "turns": turns,
                                                    "bound_us": bound_us(bk, hist)}
        log(f"sweep scatter_runs radix 16 @ {label} ({bk.numel()} keys): device us per call, "
            f"median of 2 mirrored turns: " + ", ".join(f"{k} {fmt(v)}" for k, v in row.items())
            + f"; bound {bound_us(bk, hist):.2f} us")
        del bk, bi, hist, offsets, sides
        torch.cuda.empty_cache()


def ab_sorts(old: ScatterBuild, rng, results: dict) -> None:
    cfg = EngineConfig()
    col = make_key_column(rng.integers(0, 2**32, 1 << 24, dtype=np.uint32), cfg)
    fkeys = Table({"key": make_key_column(rng.integers(0, 2**32, 100_000_000, dtype=np.uint32),
                                          cfg)})
    kept = filter_table(fkeys, lambda t: int32_bits(t["key"].data) >= 0, cfg).to_table()["key"]
    del fkeys
    for keys in (col.data, sort_ops._as_key_column(kept, cfg).data):
        if pass_mask(keys, cfg) != (1 << cfg.num_passes) - 1:
            raise SystemExit("an A/B input has a constant digit, which the old K3 cannot skip")
    torch.cuda.synchronize()
    cases = {
        "sort_pairs fused 2^24 (eager loop)": lambda: sort_pairs(col, cfg, method="fused"),
        f"sort_pairs fused of the filter's {kept.length} survivors (100M padded buffer, "
        f"eager loop)": lambda: sort_pairs(kept, cfg, method="fused"),
    }
    for name, fn in cases.items():
        outs, turns, busy = {}, {"old": [], "new": []}, {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            # The eager loop: a cached CUDA graph would replay the K3 it captured first.
            with scatter_of(side, old), mock.patch.object(sort_ops, "GRAPH_MAX_PADDED", 0):
                outs[side] = [c.data for c in fn()]
                turns[side].append(float(np.median(cuda_time_ms(fn, reps=7, warmup=1))))
                busy[side].append(profiled_device_ms(fn, calls=3)[0])
        if not same(outs["old"], outs["new"]):
            raise SystemExit(f"{name}: old and new K3 give different results")
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
                        help="directory of the older scatter_runs.cu")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's register report")
    parser.add_argument("--sweep", action="store_true",
                        help="time K3's routes and tiles a block first")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("FAIL no CUDA device")
        return 1
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    _build.library()
    old = ScatterBuild(_build.build(args.old, OLD_BUILD), planned=False)
    if args.ptxas:
        ptxas_report(SOURCE, "new scatter_runs.cu")
        ptxas_report(SOURCE, "new scatter_runs.cu, cp.async route", ["-DGRS_SCATTER_CP_ASYNC"])
        ptxas_report(args.old / "scatter_runs.cu", "old scatter_runs.cu")
    rng = np.random.default_rng(SEED)
    results: dict = {"card": card}
    if args.sweep:
        sweep(rng, results)
    phase_kernel(old, rng, results)
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
