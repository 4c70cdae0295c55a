#!/usr/bin/env python3
"""Time segment_aggregate beside variants of its kernel, on one CUDA card.

    python3 agg_ab.py [--out FILE]

``segment_aggregate`` (``csrc/segment_agg.cu``) is the group-by's step after
its sort: every aggregate of every run of equal keys, written once at the
run's slot.  This script builds, each into a library of its own under
``build/kernels_ab/``:

- ``port``: ``csrc/segment_agg.cu`` as it stands;
- ``two passes``: the same with every partition on the dense route, which
  walks its rows again for each output after the look-back (the port keeps
  the values at the run ends of a partition of at most ``kSparseGroups``
  groups and walks its rows once);
- ``32 rows a thread``: the same with partitions of 8,192 rows, 32 a thread
  (the port's 16 a thread, 4,096 a partition);
- ``look back 128 a round``: the same with a look-back round of four
  status words a lane (the port's one, 32 partitions a round);
- ``traced``: the port with thread 0 reading the SM's clock (``clock64``) at
  each step of its block (start, staged, scanned, look-back begun and
  ended, carries shared, end), kept a partition and copied out after one
  call of each case: the cycles of each step, median and 90th percentile
  over the partitions;

and times each, through the port's wrapper, beside the plain version (the
``index_add_`` / ``scatter_reduce_`` route the group-by took before the
kernel) on the group-by's inputs: its five aggregates (sum, count, min,
max, mean) of one int32 column of 0..99, on sorted keys of about 100 rows
each at 1,000,000, 2^24 and 100,000,000 rows, and at 2^24 also on keys all
equal and all unique.  Device time per call from torch.profiler: the call
whole (its memsets and its kernel) and the kernel's row alone (back-to-back
calls, median of 3 turns in alternating order), the bound (the bytes of
``bench.stage_work`` at 3.35 TB/s) and the share of it.  Every output is
checked against the plain version: keys, count, integers, min and max
equal, the mean within one float32 ulp.  nvcc's register and spill report
of each build is printed.  The card's name and power limit and one JSON
line of every number end the output; ``--out`` also writes that JSON to a
file.
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

from gpuradixsort_tpu_torch.bench import stage_work
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import make_column, make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import aggregate as agg
from gpuradixsort_tpu_torch.utils.timing import bound_of, card_line, profiled_device_ms
from gpuradixsort_tpu_torch.utils.verify import aggregate_errors

SEED = 20170101
REPO = pathlib.Path(__file__).resolve().parent
AB_BUILD = REPO / "build" / "kernels_ab"
PORT_SOURCE = REPO / "gpuradixsort_tpu_torch" / "csrc" / "segment_agg.cu"
KERNEL_ROW = "segment_agg_kernel"
AGGS = (("s", "sum"), ("c", "count"), ("lo", "min"), ("hi", "max"), ("m", "mean"))


def variants() -> dict[str, str]:
    """Each build's name and its source text."""
    port = PORT_SOURCE.read_text()
    dense = port.replace("constexpr int kSparseGroups = kPartition * 4 / (8 * kMaxAccs);",
                         "constexpr int kSparseGroups = 0;")
    wide = port.replace("constexpr int kItems = 16;", "constexpr int kItems = 32;")
    deep = port.replace("constexpr int kLookLoads = 1;", "constexpr int kLookLoads = 4;")
    if dense == port or wide == port or deep == port:
        raise RuntimeError("csrc/segment_agg.cu no longer has the lines the variants replace")
    return {"port": port, "two passes": dense, "32 rows a thread": wide,
            "look back 128 a round": deep,
            "traced": traced(port)}


# The traced build: the port's source with clock64() read by thread 0 at the
# kernel's steps, kept a partition in a device array that
# grs_segment_aggregate_trace copies out.  (anchor, marker inserted after it)
TRACE_STEPS = ("start", "staged", "scanned", "look-back begins", "look-back ends",
               "carries shared", "end")
TRACE_PARTS = 1 << 15
TRACE_HEADER = f"""
#define GRS_TRACE_PARTS {TRACE_PARTS}
__device__ long long grs_trace[GRS_TRACE_PARTS][8];
#define GRS_MARK(i) do {{ if (tid == 0 && part < GRS_TRACE_PARTS) grs_trace[part][i] = clock64(); }} while (0)
"""
TRACE_MARKS = (
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
TRACE_ENDS = (("    return;\n  }\n  // A dense partition", "    GRS_MARK(6);\n"),
              ("    __syncthreads();\n  }\n}\n\nsize_t shared_bytes", "  GRS_MARK(6);\n"))
TRACE_COPY = """
extern "C" int grs_segment_aggregate_trace(void* dst, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(dst, grs_trace, sizeof(grs_trace), 0,
                                                    cudaMemcpyDeviceToHost,
                                                    static_cast<cudaStream_t>(stream)));
}
"""


def traced(port: str) -> str:
    """The port's source with the trace markers (the start's clock read before the ticket)."""
    text = port.replace('#include "warp.cuh"\n', '#include "warp.cuh"\n' + TRACE_HEADER, 1)
    for anchor, mark in TRACE_MARKS:
        if anchor not in text:
            raise RuntimeError(f"csrc/segment_agg.cu no longer has the trace anchor {anchor!r}")
        text = text.replace(anchor, anchor + mark, 1)
    for anchor, mark in TRACE_ENDS:  # the sparse route's return, the kernel's end
        at = text.find(anchor)
        if at < 0:
            raise RuntimeError("csrc/segment_agg.cu no longer ends its kernel as the trace expects")
        cut = at + (anchor.index("return;") if "return;" in anchor else anchor.index("}\n}\n") + 2)
        text = text[:cut] + mark + text[cut:]
    # Mark 0 is taken before the ticket and the block's first barrier.
    text = text.replace("  GRS_MARK(0);\n", "", 1).replace(
        "  if (tid == 0) {\n    spec = params;",
        "  const long long start = clock64();\n  if (tid == 0) {\n    spec = params;", 1)
    text = text.replace("  const int64_t part = ticket;\n",
                        "  const int64_t part = ticket;\n"
                        "  if (tid == 0 && part < GRS_TRACE_PARTS) grs_trace[part][0] = start;\n", 1)
    return text + TRACE_COPY


def build_all() -> tuple[dict, dict]:
    """Compile every variant at once; returns (loaded libraries, ptxas line by build)."""
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(variants().items()):
        src = AB_BUILD / f"agg_variant{i}.cu"
        src.write_text(text)
        lib = AB_BUILD / f"agg_variant{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(PORT_SOURCE.parent), "-shared",
               "-Xptxas", "-v", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
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
        fn.argtypes = _build._SIGNATURES["grs_segment_aggregate"]
        fn.restype = ctypes.c_int
        libs[name] = handle
    return libs, reports


def through(lib):
    """``segment_aggregate`` on the card, its launches going to ``lib``'s entry point."""
    def launch(name, like, *args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def run(keys, n_live, inputs):
        with mock.patch.object(agg, "launch", launch):
            return agg.segment_aggregate(keys, n_live, inputs, impl="cuda")
    return run


def cases(rng, dev):
    """(label, sorted keys, live rows, inputs) of each case."""
    cfg = EngineConfig()
    draws = (("1M, ~100 rows a key", 1_000_000, lambda n: rng.integers(0, n // 100, n)),
             ("2^24, ~100 rows a key", 1 << 24, lambda n: rng.integers(0, n // 100, n)),
             ("2^24, all keys equal", 1 << 24, lambda n: np.full(n, 7)),
             ("2^24, all keys unique", 1 << 24, lambda n: np.arange(n)),
             ("100M, ~100 rows a key", 100_000_000, lambda n: rng.integers(0, n // 100, n)))
    for label, n, draw in draws:
        keys = make_key_column(np.sort(draw(n)).astype(np.uint32), cfg, device=dev).data
        val = make_column(rng.integers(0, 100, n, dtype=np.int32), cfg, device=dev).data
        yield label, keys, n, [(name, None if kind == "count" else val, kind)
                               for name, kind in AGGS]


def trace_of(lib, run, rows: int) -> dict:
    """The traced build's steps: SM cycles between its markers, median and 90th percentile
    over the partitions of one call, and the cycles a block took from start to end."""
    lib.grs_segment_aggregate_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.grs_segment_aggregate_trace.restype = ctypes.c_int
    run()
    torch.cuda.synchronize()
    host = np.zeros((TRACE_PARTS, 8), dtype=np.int64)
    err = lib.grs_segment_aggregate_trace(host.ctypes.data, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"grs_segment_aggregate_trace: CUDA error {err}")
    parts = min(-(-rows // agg.PARTITION), TRACE_PARTS)
    t = host[:parts, :len(TRACE_STEPS)].astype(np.float64)
    out = {}
    for i in range(1, len(TRACE_STEPS)):
        d = t[:, i] - t[:, i - 1]
        if i in (3, 4, 5):  # partition 0 has no marks 3 and 4
            d = (t[1:, i] - t[1:, i - 1]) if parts > 1 else d[:0]
        if d.size:
            out[f"{TRACE_STEPS[i - 1]} -> {TRACE_STEPS[i]}"] = (float(np.median(d)),
                                                                float(np.percentile(d, 90)))
    whole = t[:, -1] - t[:, 0]
    out["start -> end"] = (float(np.median(whole)), float(np.percentile(whole, 90)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("[ab] no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    libs, reports = build_all()
    for name, line in reports.items():
        print(f"[ab] ptxas {name}: {line}", flush=True)
    results = {"card": card, "ptxas": reports, "cases": {}}
    rng = np.random.default_rng(SEED)
    for label, keys, n, inputs in cases(rng, dev):
        want = agg.segment_aggregate(keys, n, inputs, impl="reference")
        fns = {name: (lambda run=through(lib): run(keys, n, inputs)) for name, lib in libs.items()}
        for name, fn in fns.items():
            for out, (err, ulps) in aggregate_errors(fn(), want).items():
                if (ulps > 1) if out == "m" else (err or ulps):
                    raise RuntimeError(f"{name} != plain, {label}: {out} {err} {ulps} ulps")
        results["cases"][label] = {"trace": trace_of(libs["traced"], fns["traced"], keys.numel())}
        fns["plain"] = lambda: agg.segment_aggregate(keys, n, inputs, impl="reference")
        calls = max(2, min(20, 200_000_000 // keys.numel()))
        turns = {name: [] for name in fns}
        alone = {name: [] for name in libs}
        for order in (list(fns), list(fns)[::-1], list(fns)):
            for name in order:
                busy, rows = profiled_device_ms(fns[name], calls=calls)
                turns[name].append(1e3 * busy)
                if name in alone:
                    alone[name].append(1e3 * sum(ms for row, ms in rows.items()
                                                 if KERNEL_ROW in row))
        bound_us = 1e3 * bound_of(*stage_work(keys.numel(), EngineConfig())["segment_aggregate"])[0]
        results["cases"][label].update({"rows": keys.numel(), "bound_us": bound_us, "us": {},
                                        "kernel_alone_us": {}})
        for step, (med, p90) in results["cases"][label]["trace"].items():
            print(f"[ab] {label}, traced build, {step}: median {med:.0f} SM cycles, 90th "
                  f"percentile {p90:.0f}", flush=True)
        for name, t in turns.items():
            us = float(np.median([x for x in t if x] or [0.0]))
            results["cases"][label]["us"][name] = us
            extra = ""
            if name in alone:
                k_us = float(np.median([x for x in alone[name] if x] or [0.0]))
                results["cases"][label]["kernel_alone_us"][name] = k_us
                extra = f", kernel alone {k_us:.2f} us"
            share = f"{bound_us / us:.3f}" if us else "not measured"
            print(f"[ab] {label} ({keys.numel()} rows), {name}: {us:.2f} us (turns "
                  f"{', '.join(f'{x:.2f}' for x in t)}){extra}; bound {bound_us:.2f} us; "
                  f"share {share} ({card})", flush=True)
        del want, fns, keys, inputs
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
