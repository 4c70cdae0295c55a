#!/usr/bin/env python3
"""Time the fused sort's two kernels, sort_plan and the look-back pass, beside an older build.

    python3 kernel_ab.py [--old DIR] [--ptxas] [--out FILE]

A fused sort is one ``sort_plan`` (``csrc/key_bits.cu``: the key read with
every pass's digit counts, the plan and the bases) and one look-back pass a
pass (``csrc/bucketize_scatter.cu``, ``grs_lookback_scatter``).  On one
CUDA card, at 1,000,000, 2^24 and 100,000,000 keys (padded as the sorts pad
them), random and skewed (one key holding 99%): device time per call
(torch.profiler, 20 back-to-back calls) of each kernel, beside its bound
(``bench.stage_work``'s bytes at 3.35 TB/s) and share of that bound.
``sort_plan`` counts its memsets with its kernels; the look-back pass is
timed on pass 0 of a radix-16 sort, its scratch cleared before each launch,
the clearing not counted.

``--old DIR`` builds an older copy of ``csrc/`` (that of commit b055d90,
whose ``grs_key_bits`` counts the digits and whose ``grs_lookback_scatter``
takes tiles) into ``build/kernels_old/`` and times it on the same input in
mirrored turns (new, old, old, new), each side with its own scratch layout;
every output is checked equal to the other side's and, at 1M and 2^24, the
look-back pass to its plain version.  ``--ptxas`` prints nvcc's register,
shared-memory and spill report of both kernels' sources (and the older
ones) and the resident warps an SM that follow.  The card's name and power
limit and one JSON line of every number end the output; ``--out`` also
writes that JSON to a file.  The A/B of the table-reading pass at each
block size is ``kernel_ab.py`` of commit b055d90.
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
from gpuradixsort_tpu_torch.core.table import int32_bits, make_key_column, pad_to_tile
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import key_bits as kb
from gpuradixsort_tpu_torch.kernels import scatter as scatter_kernels
from gpuradixsort_tpu_torch.utils.timing import bound_of, card_line, profiled_device_ms

SEED = 20170101
OLD_BUILD = pathlib.Path(__file__).resolve().parent / "build" / "kernels_old"
SIZES = {"1M": 1_000_000, "2^24": 1 << 24, "100M": 100_000_000}
KINDS = ("random", "skewed")
PLAIN_UP_TO = 1 << 24  # the look-back pass is also held to its plain version up to here
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The older build's entry points (commit b055d90).
OLD_SIGNATURES = {
    "grs_key_bits": [_P, _I64, _P, _P, _I, _I, _P, _P, _I64, _P],
    "grs_lookback_scatter": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _I, _P, _P, _P],
}


def log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args, stream())
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


class New:
    """This build: sort_plan's state and the look-back pass, as the wrappers launch them."""

    label = "new"

    def __init__(self, keys: torch.Tensor, cfg: EngineConfig):
        self.keys, self.cfg = keys, cfg
        self.skipped = torch.zeros(1, dtype=torch.int64, device=keys.device)
        self.state = kb.sort_plan(keys, cfg, self.skipped)

    def plan(self):
        self.state = kb.sort_plan(self.keys, self.cfg, self.skipped)
        return self.state

    def tables(self) -> list[torch.Tensor]:
        return [self.state.plan, self.state.counts, self.state.bases]

    def clear(self) -> None:
        self.state.lookback.zero_()

    def lookback(self, idx: torch.Tensor):
        return scatter_kernels.bucketize_scatter_lookback(self.keys, idx, self.cfg, self.state, 0)


class Old:
    """The older build: its one-allocation state (counts, lines, tile and group words)."""

    label = "old"

    def __init__(self, lib: ctypes.CDLL, keys: torch.Tensor, cfg: EngineConfig):
        self.lib, self.keys, self.cfg = lib, keys, cfg
        passes, table = cfg.num_passes, cfg.num_passes * cfg.radix
        self.tiles = keys.numel() // cfg.tile
        groups = -(-self.tiles // 32)
        head = 2 + passes + table
        self.counts = head + head % 2
        self.lookback_at = self.counts + table + 128 * 32
        total = self.lookback_at + self.tiles * cfg.radix + passes * (2 + 3 * groups * cfg.radix)
        self.state = torch.empty(total, dtype=torch.int32, device=keys.device)
        self.skipped = torch.zeros(1, dtype=torch.int64, device=keys.device)
        self.plan()

    def plan(self):
        s, cfg = self.state, self.cfg
        call(self.lib, "grs_key_bits", self.keys.data_ptr(), self.keys.numel(), s.data_ptr(),
             s[2:].data_ptr(), cfg.num_passes, cfg.radix_bits, self.skipped.data_ptr(),
             s[self.counts:].data_ptr(), 4 * (s.numel() - self.counts))
        return s

    def tables(self) -> list[torch.Tensor]:
        passes, radix = self.cfg.num_passes, self.cfg.radix
        s, table = self.state, passes * radix
        return [s[2:2 + passes], s[self.counts:self.counts + table].view(passes, radix),
                s[2 + passes:2 + passes + table].view(passes, radix)]

    def clear(self) -> None:
        self.state[self.lookback_at:].zero_()

    def lookback(self, idx: torch.Tensor):
        cfg, s = self.cfg, self.state
        out = (torch.empty_like(self.keys), torch.empty_like(idx))
        call(self.lib, "grs_lookback_scatter", self.keys.data_ptr(), idx.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), None, None, self.tiles, cfg.tile, 128, 0,
             cfg.radix, None, 0, s[2 + cfg.num_passes:].data_ptr(),
             s[self.lookback_at:].data_ptr())
        return out


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
    """Registers, spills and shared bytes of each kernel of the two sources, by ptxas."""
    report = {}
    for source in ("bucketize_scatter.cu", "key_bits.cu"):
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
            threads = 256 if label == "new" else 128
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


def measure(rng, results: dict, old: ctypes.CDLL | None) -> None:
    cfg = EngineConfig()
    for label, n in SIZES.items():
        for kind in KINDS:
            keys = make_key_column(keys_of(rng, n, kind), cfg).data
            idx = pad_to_tile(torch.arange(n, dtype=torch.int32, device=keys.device)
                              .view(torch.uint32), cfg, PAD_INDEX)
            sides = [New(keys, cfg)] + ([Old(old, keys, cfg)] if old is not None else [])
            got = [side.lookback(idx) for side in sides]
            where = f"{label} {kind}"
            if old is not None:
                differ = [name for name, a, b in zip(("plan", "counts", "bases"),
                                                     sides[0].tables(), sides[1].tables())
                          if not torch.equal(a, b)]
                if differ:
                    want = kb.sort_plan(keys, cfg, torch.zeros_like(sides[0].skipped),
                                        impl="reference")
                    wrong = {s.label: [name for name, a, b in zip(
                        ("plan", "counts", "bases"), s.tables(), want[:3]) if not torch.equal(a, b)]
                        for s in sides}
                    raise SystemExit(f"sort_plan {where}: the two builds differ in {differ}; "
                                     f"unequal to the plain version: {wrong}")
                if not same(*got):
                    raise SystemExit(f"look-back pass {where}: the two builds differ")
            if keys.numel() <= PLAIN_UP_TO:
                want = scatter_kernels.bucketize_scatter_lookback(
                    keys, idx, cfg, sides[0].state, 0, impl="reference")
                if not same(got[0], want):
                    raise SystemExit(f"look-back pass {where}: differs from the plain version")
                del want
            del got
            work = stage_work(keys.numel(), cfg)
            for kernel, fns, only in (
                    ("sort_plan", {s.label: s.plan for s in sides}, None),
                    ("lookback", {s.label: (lambda s=s: (s.clear(), s.lookback(idx)))
                                  for s in sides}, "lookback_scatter")):
                turns = {name: [] for name in fns}
                for name in list(fns) + list(fns)[::-1]:  # mirrored turns
                    turns[name].append(device_us(fns[name], only))
                row = {name: float(np.median([t for t in ts if t] or [0.0]))
                       for name, ts in turns.items()}
                stage = "sort_plan" if kernel == "sort_plan" else "bucketize_scatter_lookback"
                bound = bound_of(*work[stage])[0] * 1e3
                results[f"{kernel} @ {label} {kind}"] = {
                    **row, "turns": turns, "bound_us": bound, "padded": keys.numel()}
                log(f"{kernel} @ {label} {kind} ({keys.numel()} keys): device us per call, "
                    "median of mirrored turns: " + ", ".join(
                        f"{k} {fmt(v)} (share of bound {fmt(bound / v if v else 0, 3)})"
                        for k, v in row.items()) + f"; bound {bound:.2f} us")
            del keys, idx, sides
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
    results: dict = {"card": card}
    if args.ptxas:
        results["ptxas"] = {"new": ptxas_report("new", _build._CSRC)}
        if args.old:
            results["ptxas"]["old"] = ptxas_report("old", args.old)
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
