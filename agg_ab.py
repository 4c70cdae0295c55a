#!/usr/bin/env python3
"""Time segment_aggregate beside variants of its kernel and an older build, on one CUDA card.

    python3 agg_ab.py [--old DIR] [--out FILE]

``segment_aggregate`` (``csrc/segment_agg.cu``) is the group-by's step after
its sort: every aggregate of every run of equal keys, written once at the
run's slot, its columns read in key order or through the sort's
permutation (``rows``).  This script builds, each into a library of its own
under ``build/kernels_ab/``:

- ``port``: ``csrc/segment_agg.cu`` as it stands (8 walking warps and a
  look-back warp a block, 288 threads, a partition of 4,096 rows);
- ``7 walking warps``: the same with 7 walking warps and the look-back warp,
  256 threads and 3,584 rows a block (at most 80 registers);
- ``traced``: the port built with ``-DGRS_TRACE``, whose blocks keep the
  SM's clock (``clock64``) at each step, copied out after one call of each
  case: the cycles of each step, median and 90th percentile over the
  partitions;

and, with ``--old DIR`` (a directory holding an older ``segment_agg.cu``
and its headers, e.g. ``chip_scratch/parent/gpuradixsort_tpu_torch/csrc``
from a ``git archive`` of the parent commit, whose kernel reads its columns
in key order only), ``parent`` and ``parent traced`` (the older source with
thread 0 reading the clock at its steps: start, staged, scanned, look-back
begun and ended, carries shared, end).  The parent reads a column through
rows as its group-by did: ``gather_rows`` first.

Each is driven through the port's wrapper (``mock.patch`` of its ``launch``
and ``PARTITION``; the parent's through an adapter to its entry point) on
the group-by's inputs: its five aggregates (sum, count, min, max, mean) of
one int32 column of 0..99, on sorted keys of about 100 rows each at
1,000,000, 2^24 and 100,000,000 rows, and at 2^24 also on keys all equal
and all unique, each with the column in key order and read through a
random permutation (-1 on no row: every row is live).  Device time per
call from torch.profiler: the call whole (its memsets and its kernel; the
parent's through rows with its gather) and the kernel's row alone
(back-to-back calls, median of 3 turns in alternating order), the bound
(the bytes of ``bench.stage_work`` at 3.35 TB/s) and the share of it.
With ``--old`` also the 100M-row, 1M-key group-by, ``group_by_aggregate``
against the parent's route (``sort_table``, then the older kernel on the
gathered column), by CUDA events in turns parent, port, port, parent.
Every output is checked against the plain version: keys, count, integers,
min and max equal, the mean within one float32 ulp; the two group-bys
against each other.  nvcc's register and spill report of each build is
printed.  The card's name and power limit and one JSON line of every
number end the output; ``--out`` also writes that JSON to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from gpuradixsort_tpu_torch.bench import gather_sector_bytes, stage_work
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Table, make_column, make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import aggregate as agg
from gpuradixsort_tpu_torch.ops.aggregate import group_by_aggregate
from gpuradixsort_tpu_torch.ops.permute import gather_rows
from gpuradixsort_tpu_torch.ops.sort import sort_table
from gpuradixsort_tpu_torch.utils.timing import (
    HBM_PEAK_TBS,
    bound_of,
    card_line,
    per_call_ms,
    profiled_device_ms,
)
from gpuradixsort_tpu_torch.utils.verify import aggregate_errors

SEED = 20170101
REPO = pathlib.Path(__file__).resolve().parent
AB_BUILD = REPO / "build" / "kernels_ab"
PORT_SOURCE = REPO / "gpuradixsort_tpu_torch" / "csrc" / "segment_agg.cu"
KERNEL_ROW = "segment_agg_kernel"
AGGS = (("s", "sum"), ("c", "count"), ("lo", "min"), ("hi", "max"), ("m", "mean"))
GROUP_AGGS = {name: ("val", kind) for name, kind in AGGS}
N_GROUPS = 1_000_000
OLD_PARTITION = 4096  # the parent's rows a block
VARIANT_PARTITION = {"7 walking warps": 7 * 512}  # a variant's rows a block, where not the port's


def variants(old: pathlib.Path | None) -> dict[str, tuple[str, pathlib.Path, list, int]]:
    """Each build's name: (source text, include directory, extra nvcc flags, rows a block)."""
    port = PORT_SOURCE.read_text()
    swaps = {"7 walking warps": ("constexpr int kWalkWarps = 8;", "constexpr int kWalkWarps = 7;")}
    inc = PORT_SOURCE.parent
    out = {"port": (port, inc, [], agg.PARTITION)}
    for name, (line, swap) in swaps.items():
        if line not in port:
            raise RuntimeError(f"csrc/segment_agg.cu no longer has the line {line!r}")
        out[name] = (port.replace(line, swap), inc, [], VARIANT_PARTITION.get(name, agg.PARTITION))
    out["traced"] = (port, inc, ["-DGRS_TRACE"], agg.PARTITION)
    if old is not None:
        text = (old / "segment_agg.cu").read_text()
        out["parent"] = (text, old, [], OLD_PARTITION)
        out["parent traced"] = (old_traced(text), old, [], OLD_PARTITION)
    return out


# The parent's traced build: its source with clock64() read by thread 0 at
# its steps, kept a partition in a device array that
# grs_segment_aggregate_trace copies out.  (anchor, marker inserted after it)
OLD_TRACE_STEPS = ("start", "staged", "scanned", "look-back begins", "look-back ends",
                   "carries shared", "end")
TRACE_PARTS = 1 << 15
OLD_TRACE_HEADER = f"""
#define GRS_TRACE_PARTS {TRACE_PARTS}
__device__ long long grs_trace[GRS_TRACE_PARTS][8];
#define GRS_MARK(i) do {{ if (tid == 0 && part < GRS_TRACE_PARTS) grs_trace[part][i] = clock64(); }} while (0)
"""
OLD_TRACE_MARKS = (
    ("    live_rows = l < 0 ? 0 : (l > n ? n : l);\n  }\n  __syncthreads();\n"
     "  const int64_t part = ticket;\n", "  GRS_MARK(0);\n"),
    ("cstage + c * kStageWords + warp * kSpanWords, lane);\n  __syncthreads();\n",
     "  GRS_MARK(1);\n"),
    ("      if (lane == 31) wtot[a * kWarps + warp] = to_bits(s);\n    });\n  }\n"
     "  __syncthreads();\n", "  GRS_MARK(2);\n"),
    ("      __syncwarp();\n", "      GRS_MARK(3);\n"),
    ("      base = look_back(sc, spec, part, lane, carry);\n", "      GRS_MARK(4);\n"),
    ("        *count_out = static_cast<int32_t>(base + static_cast<uint32_t>(groups));\n"
     "    }\n  }\n  __syncthreads();\n", "  GRS_MARK(5);\n"),
)
OLD_TRACE_ENDS = (("    return;\n  }\n  // A dense partition", "    GRS_MARK(6);\n"),
                  ("    __syncthreads();\n  }\n}\n\nsize_t shared_bytes", "  GRS_MARK(6);\n"))
OLD_TRACE_COPY = """
extern "C" int grs_segment_aggregate_trace(void* dst, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(dst, grs_trace, sizeof(grs_trace), 0,
                                                    cudaMemcpyDeviceToHost,
                                                    static_cast<cudaStream_t>(stream)));
}
"""


def old_traced(text: str) -> str:
    """The parent's source with the trace markers (the start's clock read before the ticket)."""
    text = text.replace('#include "warp.cuh"\n', '#include "warp.cuh"\n' + OLD_TRACE_HEADER, 1)
    for anchor, mark in OLD_TRACE_MARKS:
        if anchor not in text:
            raise RuntimeError(f"the older segment_agg.cu lacks the trace anchor {anchor!r}")
        text = text.replace(anchor, anchor + mark, 1)
    for anchor, mark in OLD_TRACE_ENDS:  # the sparse route's return, the kernel's end
        at = text.find(anchor)
        if at < 0:
            raise RuntimeError("the older segment_agg.cu no longer ends its kernel as expected")
        cut = at + (anchor.index("return;") if "return;" in anchor else anchor.index("}\n}\n") + 2)
        text = text[:cut] + mark + text[cut:]
    text = text.replace("  GRS_MARK(0);\n", "", 1).replace(
        "  if (tid == 0) {\n    spec = params;",
        "  const long long start = clock64();\n  if (tid == 0) {\n    spec = params;", 1)
    text = text.replace("  const int64_t part = ticket;\n",
                        "  const int64_t part = ticket;\n"
                        "  if (tid == 0 && part < GRS_TRACE_PARTS) grs_trace[part][0] = start;\n", 1)
    return text + OLD_TRACE_COPY


# The port's traced steps: (label, from mark, to mark), marks as
# csrc/segment_agg.cu's GRS_MARK numbers them.  Marks 4 and 5 are the
# look-back warp's (partitions after the first), 7 and 8 those of partitions
# with a run end.
TRACE_STEPS = (("staged", 0, 1), ("heads and tails", 1, 2), ("last run folded", 2, 3),
               ("aggregate published (look-back warp)", 3, 4),
               ("look-back, inclusive published (look-back warp)", 4, 5),
               ("walks, warp scans, warps' totals scanned", 3, 7),
               ("waiting for the look-back warp", 7, 8), ("carries and stores", 8, 9),
               ("start -> inclusive published", 0, 5), ("start -> end", 0, 9))
OLD_STEPS = tuple((f"{OLD_TRACE_STEPS[i - 1]} -> {OLD_TRACE_STEPS[i]}", i - 1, i)
                  for i in range(1, len(OLD_TRACE_STEPS))) + (("start -> end", 0, 6),)


def build_all(old: pathlib.Path | None) -> tuple[dict, dict, dict]:
    """Compile every build at once; returns (loaded libraries, rows a block, ptxas line)."""
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    jobs, parts = {}, {}
    for i, (name, (text, inc, flags, partition)) in enumerate(variants(old).items()):
        src = AB_BUILD / f"agg_variant{i}.cu"
        src.write_text(text)
        lib = AB_BUILD / f"agg_variant{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(inc), "-shared",
               "-Xptxas", "-v", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
        parts[name] = partition
    libs, reports = {}, {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        reports[name] = "; ".join(
            lines[i + 1].strip() + "; " + lines[i + 2].split(":", 1)[1].strip()
            for i, line in enumerate(lines)
            if "Function properties for" in line and KERNEL_ROW in line)
        handle = ctypes.CDLL(str(lib))
        fn = handle.grs_segment_aggregate
        sig = _build._SIGNATURES["grs_segment_aggregate"]
        fn.argtypes = sig[:4] + sig[5:] if name.startswith("parent") else sig  # no rows
        fn.restype = ctypes.c_int
        libs[name] = handle
    return libs, parts, reports


def _old_words(spec_addr: int, nwords: int) -> tuple[ctypes.Array, int]:
    """The parent's spec words from the port's: a column's address without its rows."""
    words = list((ctypes.c_int64 * nwords).from_address(spec_addr))
    ncol = words[0]
    old = words[:3] + words[3:3 + 2 * ncol:2] + words[3 + 2 * ncol:]
    return (ctypes.c_int64 * len(old))(*old), len(old)


def through(lib, partition: int, parent: bool):
    """``segment_aggregate`` on the card, its launches going to ``lib``'s entry point.

    The parent's entry point takes no rows: it reads a column through rows as
    its group-by did, after ``gather_rows``.
    """
    def launch(name, like, *args):
        stream = torch.cuda.current_stream().cuda_stream
        if parent:
            keys, n, live_ptr, live_value, rows, spec, nwords, *rest = args
            if rows is not None:
                raise RuntimeError("the parent's kernel reads no rows")
            words, nwords = _old_words(spec, nwords)
            err = getattr(lib, name)(keys, n, live_ptr, live_value, ctypes.addressof(words),
                                     nwords, *rest, stream)
        else:
            err = getattr(lib, name)(*args, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def run(keys, n_live, inputs, rows=None):
        if parent and rows is not None:
            gathered = {id(v): gather_rows(v, rows) for _, v, _ in inputs if v is not None}
            inputs = [(name, None if v is None else gathered[id(v)], kind)
                      for name, v, kind in inputs]
            rows = None
        with mock.patch.object(agg, "launch", launch), \
                mock.patch.object(agg, "PARTITION", partition):
            return agg.segment_aggregate(keys, n_live, inputs, rows, impl="cuda")
    return run


def cases(rng, dev):
    """(label, sorted keys, live rows, inputs, a random permutation) of each case."""
    cfg = EngineConfig()
    draws = (("1M, ~100 rows a key", 1_000_000, lambda n: rng.integers(0, n // 100, n)),
             ("2^24, ~100 rows a key", 1 << 24, lambda n: rng.integers(0, n // 100, n)),
             ("2^24, all keys equal", 1 << 24, lambda n: np.full(n, 7)),
             ("2^24, all keys unique", 1 << 24, lambda n: np.arange(n)),
             ("100M, ~100 rows a key", 100_000_000, lambda n: rng.integers(0, n // 100, n)))
    for label, n, draw in draws:
        keys = make_key_column(np.sort(draw(n)).astype(np.uint32), cfg, device=dev).data
        val = make_column(rng.integers(0, 100, n, dtype=np.int32), cfg, device=dev).data
        rows = torch.from_numpy(rng.permutation(keys.numel()).astype(np.int32)).to(dev)
        rows[n:] = -1
        yield label, keys, n, [(name, None if kind == "count" else val, kind)
                               for name, kind in AGGS], rows


def trace_of(lib, run, rows: int, partition: int, width: int, steps) -> dict:
    """A traced build's steps: SM cycles between its marks, median and 90th percentile over
    the partitions of one call that reached both marks (and how many did)."""
    lib.grs_segment_aggregate_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.grs_segment_aggregate_trace.restype = ctypes.c_int
    host = np.zeros((TRACE_PARTS, width), dtype=np.int64)
    stream = torch.cuda.current_stream().cuda_stream
    lib.grs_segment_aggregate_trace(host.ctypes.data, stream)  # clears the port's marks
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    err = lib.grs_segment_aggregate_trace(host.ctypes.data, stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"grs_segment_aggregate_trace: CUDA error {err}")
    parts = min(-(-rows // partition), TRACE_PARTS)
    t = host[:parts].astype(np.float64)
    out = {}
    for label, a, b in steps:
        both = (t[:, a] != 0) & (t[:, b] != 0)
        d = (t[both, b] - t[both, a])
        if d.size:
            out[label] = (float(np.median(d)), float(np.percentile(d, 90)), int(d.size))
    return out


def checked(fn, want, label: str) -> None:
    for out, (err, ulps) in aggregate_errors(fn(), want).items():
        if (ulps > 1) if out == "m" else (err or ulps):
            raise RuntimeError(f"!= plain, {label}: {out} {err} {ulps} ulps")


def median(xs) -> float:
    return float(np.median([x for x in xs if x] or [0.0]))


def group_by_ab(libs, parts, rng, dev, card: str) -> dict:
    """The 100M-row, 1M-key group-by: the port's against the parent's route, by events."""
    cfg = EngineConfig()
    n = 100_000_000
    pool = np.unique(rng.integers(0, 2**32, N_GROUPS * 5 // 4, dtype=np.uint32))
    pool = np.sort(rng.permutation(pool)[:N_GROUPS])
    table = Table({"key": make_key_column(pool[rng.integers(0, N_GROUPS, n)], cfg, device=dev),
                   "val": make_column(rng.integers(0, 100, n, dtype=np.int32), cfg, device=dev)})
    old_run = through(libs["parent"], parts["parent"], parent=True)

    def parent():
        ordered = sort_table(table, "key", cfg)
        return old_run(ordered["key"].data, n, [(name, None if kind == "count"
                                                 else ordered["val"].data, kind)
                                                for name, (_, kind) in GROUP_AGGS.items()])

    def port():
        sel = group_by_aggregate(table, "key", GROUP_AGGS, cfg)
        return sel.table["key"].data, {k: sel.table[k].data for k in GROUP_AGGS}, sel.count

    checked(port, parent(), "the group-by, the port against the parent")
    turns = {"parent": [], "port": []}
    for side in ("parent", "port", "port", "parent", "parent", "port"):
        fn = parent if side == "parent" else port
        turns[side].extend(per_call_ms(fn, calls=1, reps=3))
    out = {side: median(t) for side, t in turns.items()}
    for side, t in turns.items():
        print(f"[ab] group_by_aggregate, 100M rows, 1M keys, 5 aggregates, {side}: "
              f"{out[side]:.3f} ms by CUDA events (median of {len(t)}: "
              f"{', '.join(f'{x:.3f}' for x in t)}) ({card})", flush=True)
    del table
    torch.cuda.empty_cache()
    return {"ms": out, "turns": turns}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=pathlib.Path,
                        help="a directory holding an older segment_agg.cu and its headers")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("[ab] no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    libs, parts, reports = build_all(args.old)
    for name, line in reports.items():
        print(f"[ab] ptxas {name}: {line}", flush=True)
    results = {"card": card, "ptxas": reports, "cases": {}}
    rng = np.random.default_rng(SEED)
    if args.old is not None:
        results["group_by"] = group_by_ab(libs, parts, rng, dev, card)
    timed = [name for name in libs if "traced" not in name]
    for label, keys, n, inputs, rows in cases(rng, dev):
        case = results["cases"][label] = {"rows": keys.numel(), "forms": {}}
        for form, form_rows in (("in key order", None), ("through rows", rows)):
            want = agg.segment_aggregate(keys, n, inputs, form_rows, impl="reference")
            runs = {name: through(lib, parts[name], name.startswith("parent"))
                    for name, lib in libs.items()}
            fns = {name: (lambda run=run: run(keys, n, inputs, form_rows))
                   for name, run in runs.items()}
            for name, fn in fns.items():
                checked(fn, want, f"{name}, {label}, {form}")
            traces = {"traced": trace_of(libs["traced"], fns["traced"], keys.numel(),
                                         parts["traced"], 10, TRACE_STEPS)}
            if "parent traced" in libs:
                traces["parent traced"] = trace_of(libs["parent traced"], fns["parent traced"],
                                                   keys.numel(), OLD_PARTITION, 8, OLD_STEPS)
            fns = {name: fns[name] for name in timed}
            if form == "in key order":
                fns["plain"] = lambda: agg.segment_aggregate(keys, n, inputs, impl="reference")
            calls = max(2, min(20, 200_000_000 // keys.numel()))
            turns = {name: [] for name in fns}
            alone = {name: [] for name in timed}
            order = list(fns)
            for sides in (order, order[::-1], order):
                for name in sides:
                    busy, prof = profiled_device_ms(fns[name], calls=calls)
                    turns[name].append(1e3 * busy)
                    if name in alone:
                        alone[name].append(1e3 * sum(ms for row, ms in prof.items()
                                                     if KERNEL_ROW in row))
            work = stage_work(keys.numel(), EngineConfig(), agg_rows=form_rows is not None)
            bound_us = 1e3 * bound_of(*work["segment_aggregate"])[0]
            sector_us = (gather_sector_bytes(n) / (HBM_PEAK_TBS * 1e12) * 1e6
                         if form_rows is not None else None)
            entry = case["forms"][form] = {"bound_us": bound_us, "sector_us": sector_us,
                                           "us": {}, "kernel_alone_us": {}, "trace": traces}
            for build, trace in traces.items():
                for step, (med, p90, count) in trace.items():
                    print(f"[ab] {label}, {form}, {build} build, {step}: median {med:.0f} SM "
                          f"cycles, 90th percentile {p90:.0f} ({count} partitions)", flush=True)
            for name, t in turns.items():
                us = median(t)
                entry["us"][name] = us
                extra = ""
                if name in alone:
                    k_us = median(alone[name])
                    entry["kernel_alone_us"][name] = k_us
                    extra = f", kernel alone {k_us:.2f} us"
                share = f"{bound_us / us:.3f}" if us else "not measured"
                note = f"; the gather's sectors {sector_us:.2f} us" if sector_us else ""
                print(f"[ab] {label} ({keys.numel()} rows), {form}, {name}: {us:.2f} us (turns "
                      f"{', '.join(f'{x:.2f}' for x in t)}){extra}; bound {bound_us:.2f} us; "
                      f"share {share}{note} ({card})", flush=True)
            del want, fns, runs
        del keys, inputs, rows
        torch.cuda.empty_cache()
    line = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(card, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
