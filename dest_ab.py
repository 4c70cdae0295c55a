#!/usr/bin/env python3
"""Time dest_scatter beside other designs of the same function, on one CUDA card.

    python3 dest_ab.py [--out FILE]

``dest_scatter`` (``csrc/radix_dest.cu``) is one radix pass's moves: K4's
destinations and the indexed stores after them, in one kernel that stages
each tile's permutation in shared memory.  This script builds, each into a
library of its own under ``build/kernels_ab/``:

- ``port``: ``csrc/radix_dest.cu`` as it stands;
- ``rank batch 32``: the same with 32 keys a lane loaded before they are
  ranked (K4's batch; the port's first build) in place of 16;
- ``launch bounds 128, 6``: the same with at most 85 registers a thread;
- ``direct``: the route the port does not take, whose source is below:
  K4's rank step with each key's destination kept in its lane's register,
  and every column's row stored there by the lane that read it (coalesced
  loads, stores spread over the tile's digit runs);

and times each beside K4 then ``scatter_by_destination`` (the plain stores
it replaces) on the same input: (key, index) pairs as a radix pass moves
them at 1,000,000, 2^24 and 100,000,000 keys, radix 2, 16 and 256, and the
filter's compaction of 100,000,000 rows (1-bit digits of a mask, one uint32
column moved).  Device time per call from torch.profiler (20 back-to-back
calls, median of 3 turns in alternating order), the bound (the bytes at
3.35 TB/s: ``bench.stage_work``'s, plus the digits read where they are not
a moved column) and the share of it.  Every output is checked equal to the
plain version.  nvcc's register and spill report of each build is printed.
The card's name and power limit and one JSON line of every number end the
output; ``--out`` also writes that JSON to a file.
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
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.ops.permute import scatter_by_destination
from gpuradixsort_tpu_torch.utils.timing import bound_of, card_line, profiled_device_ms

SEED = 20170101
REPO = pathlib.Path(__file__).resolve().parent
AB_BUILD = REPO / "build" / "kernels_ab"
PORT_SOURCE = REPO / "gpuradixsort_tpu_torch" / "csrc" / "radix_dest.cu"

# The direct route, with the port's entry point and descriptors, so that one
# caller drives every build.
DIRECT_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kMaxColumns = 8, kBatch = 16, kMoveBatch = 8, kMaxWarps = 8;

struct MovedColumn {
  const void* src;
  void* dst;
  int64_t units;
  int64_t unit;
};

struct MovedColumns {
  MovedColumn col[kMaxColumns];
  int count;
};

template <typename T>
__device__ __forceinline__ void move(const MovedColumn& c, int64_t first, const int (&o)[kBatch],
                                     int items) {
  const T* in = static_cast<const T*>(c.src);
  T* out = static_cast<T*>(c.dst);
  if (c.units == 1) {
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kMoveBatch) {
      T v[kMoveBatch];
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j)
        if (j0 + j < items) v[j] = in[first + 32 * (j0 + j)];
#pragma unroll
      for (int j = 0; j < kMoveBatch; ++j)
        if (j0 + j < items) out[o[j0 + j]] = v[j];
    }
  } else {
    const int64_t w = c.units;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < items)
        for (int64_t k = 0; k < w; ++k) out[o[j] * w + k] = in[(first + 32 * j) * w + k];
  }
}

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    direct_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ offsets,
                  const MovedColumns cols, int64_t num_tiles, int tile, int shift) {
  constexpr int kRadix = 1 << kBits;
  constexpr uint32_t kMask = kRadix - 1;
  extern __shared__ int tables[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;
  const int64_t base = t * tile;
  const int32_t* row = offsets + t * kRadix;
  const unsigned below = (1u << lane) - 1u;
  const int items = tile >> 5;
  int running = 0;
  int* table = tables + warp * kRadix;
  if constexpr (kRadix <= 32) {
    if (lane < kRadix) running = row[lane];
  } else {
    for (int r = lane; r < kRadix; r += 32) table[r] = row[r];
    __syncwarp();
  }
  for (int j0 = 0; j0 < items; j0 += kBatch) {
    uint32_t k[kBatch];
    int o[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j0 + j < items) k[j] = __ldg(keys + base + lane + 32 * (j0 + j));
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {
        const uint32_t d = (k[j] >> shift) & kMask;
        const grs::DigitBallots<kBits> ballots(d, kBits);
        const unsigned peers = ballots.lanes_with(d, kBits);
        const int rank = __popc(peers & below);
        if constexpr (kRadix <= 32) {
          o[j] = __shfl_sync(grs::kFullWarp, running, d) + rank;
          running += __popc(ballots.lanes_with(lane, kBits));
        } else {
          o[j] = table[d] + rank;
          __syncwarp();
          if (rank == 0) table[d] += __popc(peers);
          __syncwarp();
        }
      }
    }
    const int left = items - j0 < kBatch ? items - j0 : kBatch;
    const int64_t first = base + 32 * j0 + lane;
    for (int c = 0; c < cols.count; ++c) {
      switch (cols.col[c].unit) {
        case 16: move<uint4>(cols.col[c], first, o, left); break;
        case 8: move<uint2>(cols.col[c], first, o, left); break;
        case 4: move<uint32_t>(cols.col[c], first, o, left); break;
        case 2: move<uint16_t>(cols.col[c], first, o, left); break;
        default: move<uint8_t>(cols.col[c], first, o, left); break;
      }
    }
  }
}

}  // namespace

extern "C" int grs_radix_dest_scatter(const void* keys, const void* hist, const void* offsets,
                                      const int64_t* columns, int num_columns,
                                      int64_t num_tiles, int tile, int threads, int shift,
                                      int radix, void* stream) {
  if (radix < 2 || radix > 256 || (radix & (radix - 1)) != 0 || threads < 32 ||
      threads % 32 != 0 || threads > 32 * kMaxWarps || tile <= 0 || tile % 128 != 0 ||
      num_columns < 1 || num_columns > kMaxColumns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MovedColumns cols{};
  cols.count = num_columns;
  for (int c = 0; c < num_columns; ++c) {
    const int64_t* w = columns + 4 * c;
    cols.col[c] = {reinterpret_cast<const void*>(w[0]), reinterpret_cast<void*>(w[1]), w[2],
                   w[3]};
  }
  const size_t smem = radix > 32 ? static_cast<size_t>(threads / 32) * radix * 4 : 0;
  const int64_t per_block = threads / 32;
  const dim3 grid(static_cast<unsigned>((num_tiles + per_block - 1) / per_block));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* o = static_cast<const int32_t*>(offsets);
  if (num_tiles > 0) {
    switch (__builtin_ctz(static_cast<unsigned>(radix))) {
      case 1: direct_kernel<1><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 2: direct_kernel<2><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 3: direct_kernel<3><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 4: direct_kernel<4><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 5: direct_kernel<5><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 6: direct_kernel<6><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      case 7: direct_kernel<7><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
      default: direct_kernel<8><<<grid, threads, smem, s>>>(k, o, cols, num_tiles, tile, shift); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def variants() -> dict[str, str]:
    """Each build's name and its source text."""
    port = PORT_SOURCE.read_text()
    batch = port.replace("constexpr int kRankBatch = 16;", "constexpr int kRankBatch = 32;")
    bounds = port.replace("__launch_bounds__(32 * kMaxWarps)\n    dest_scatter_kernel",
                          "__launch_bounds__(128, 6)\n    dest_scatter_kernel")
    if batch == port or bounds == port:
        raise RuntimeError("csrc/radix_dest.cu no longer has the lines the variants replace")
    return {"port": port, "rank batch 32": batch, "launch bounds 128, 6": bounds,
            "direct": DIRECT_SOURCE}


def build_all() -> tuple[dict, dict]:
    """Compile every variant at once; returns (loaded libraries, ptxas lines by build)."""
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(variants().items()):
        src = AB_BUILD / f"variant{i}.cu"
        src.write_text(text)
        lib = AB_BUILD / f"variant{i}.so"
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
        kernel = re.compile(r"Function properties for \S*(?:dest_scatter|direct)_kernelILi(\d)E")
        reports[name] = [
            f"radix {1 << int(m.group(1))}: " + lines[i + 1].strip() + "; "
            + lines[i + 2].split(":", 1)[1].strip()
            for i, line in enumerate(lines) if (m := kernel.search(line))]
        handle = ctypes.CDLL(str(lib))
        fn = handle.grs_radix_dest_scatter
        fn.argtypes = _build._SIGNATURES["grs_radix_dest_scatter"]
        fn.restype = ctypes.c_int
        libs[name] = handle
    return libs, reports


def launcher(lib, keys, hist, offsets, cfg, columns):
    """One launch of ``lib``'s entry point moving ``columns`` (4-byte words) into new outputs."""
    threads, _ = rk.dest_scatter_geometry(cfg)
    outs = [torch.empty_like(c) for c in columns]
    words = (ctypes.c_int64 * (4 * len(columns)))(
        *(w for c, o in zip(columns, outs) for w in (c.data_ptr(), o.data_ptr(), 1, 4)))

    def run():
        err = lib.grs_radix_dest_scatter(
            keys.data_ptr(), hist.data_ptr(), offsets.data_ptr(), ctypes.addressof(words),
            len(columns), keys.numel() // cfg.tile, cfg.tile, threads, 0, cfg.radix,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"grs_radix_dest_scatter: CUDA error {err}")
        return outs
    return run


def cases(rng, dev):
    """(label, rank keys, columns moved, cfg, bytes of the bound) of each case."""
    for label, n in (("1M", 1_000_000), ("2^24", 1 << 24), ("100M", 100_000_000)):
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), EngineConfig(),
                               device=dev).data
        idx = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
        for bits in (1, 4, 8):
            cfg = EngineConfig(radix_bits=bits)
            yield (f"(key, index) @ {label}, radix {cfg.radix}", keys, [keys.view(torch.int32), idx],
                   cfg, stage_work(keys.numel(), cfg)["dest_scatter"][0])
        del idx
    mask = torch.from_numpy(rng.integers(0, 2, keys.numel()).astype(np.int32)).to(dev)
    digits = (1 - mask).view(torch.uint32)
    cfg = EngineConfig(radix_bits=1)
    yield ("compaction @ 100M, 1-bit digits, one column", digits, [keys.view(torch.int32)], cfg,
           4 * keys.numel() + stage_work(keys.numel(), cfg, words=1)["dest_scatter"][0])


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
    for name, lines in reports.items():
        for line in lines:
            print(f"[ab] ptxas {name} {line}", flush=True)
    results = {"card": card, "ptxas": reports, "cases": {}}
    rng = np.random.default_rng(SEED)
    for label, keys, columns, cfg, nbytes in cases(rng, dev):
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        want = rk.dest_scatter(keys, hist, offsets, 0, cfg, columns, impl="reference")
        fns = {name: launcher(lib, keys, hist, offsets, cfg, columns) for name, lib in libs.items()}
        fns["K4 + scatter_by_destination"] = lambda: scatter_by_destination(
            rk.tile_destinations(keys, offsets, 0, cfg), columns)
        for name, fn in fns.items():
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise RuntimeError(f"{name} != plain, {label}")
        turns = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1], list(fns)):
            for name in order:
                turns[name].append(1e3 * profiled_device_ms(fns[name], calls=20)[0])
        bound_us = 1e3 * bound_of(nbytes, 0)[0]
        results["cases"][label] = {"bound_us": bound_us, "us": {}}
        for name, t in turns.items():
            us = float(np.median(t))
            results["cases"][label]["us"][name] = us
            print(f"[ab] {label}, {name}: {us:.2f} us (turns {', '.join(f'{x:.2f}' for x in t)}); "
                  f"bound {bound_us:.2f} us; share {bound_us / us:.3f} ({card})", flush=True)
        del hist, offsets, want, fns
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
