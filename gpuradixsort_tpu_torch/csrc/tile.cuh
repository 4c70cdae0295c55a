// The rank step and the place step of one tile, shared by K2
// (bucketize.cu) and K3 (scatter_runs.cu), and the ranks and loads of the
// fused sort's pass (bucketize_scatter.cu: warp_ranks, load_global,
// load_generic).  One warp owns a tile; nothing here needs a block
// barrier.
//
// rank: a tile's (key, index) pairs stably sorted by digit into the warp's
//   shared staging (K2's step): one ballot per digit bit gives each item
//   its slot among the earlier items of its digit, lane r keeps the running
//   count of digit r, and one warp scan of the counts gives the digit
//   starts.
// place: a digit-major tile's slot p goes to delta[r] + p, where r is the
//   run holding p and delta[r] = offsets[t, r] - start[r] (K3's step): a
//   store instruction covers 32 neighbouring slots, one or two runs, so
//   the stores stay coalesced.

#pragma once

#include <climits>
#include <cstdint>

#include "warp.cuh"

namespace grs {

constexpr int kFastTile = 1024;  // the default tile: 32 keys a lane
constexpr int kFastItems = kFastTile / 32;

// offsets - local_off, clamped so that delta + p never overflows for p < tile
// and stays out of [0, n) exactly when the true value is (n <= INT_MAX - tile).
__device__ __forceinline__ int run_delta(int offset, int local, int tile) {
  const long long d = static_cast<long long>(offset) - local;
  const long long lo = -(1LL << 30), hi = INT_MAX - tile;
  return static_cast<int>(d < lo ? lo : (d > hi ? hi : d));
}

__device__ __forceinline__ bool in_range(int dst, int n) {
  return static_cast<unsigned>(dst) < static_cast<unsigned>(n);
}

// Loads that stay ahead of the tile's stores.  ptxas sinks a load that it
// knows no store can alias (ld.global.nc, or any load from shared memory)
// down to its one use, the range-checked store, and then a lane's loads no
// longer overlap: K3 took about 35% longer at 2^24 keys on an H100 80GB
// HBM3 (PERF.md, Findings).  A coherent global load, or a generic load of
// the shared buffer, may alias the stores, so ptxas leaves it in place.
__device__ __forceinline__ uint32_t load_global(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t load_generic(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The ranks of a warp's kItems items a lane (warp-striped: item j is
// element 32 j + lane of the warp's run of 32 kItems elements): slot[j] is
// item j's place among the earlier items of its digit.  Returns lane r's
// count of digit r (garbage in lanes >= 2^kBits).  One ballot per digit bit
// and item; all 32 lanes call it.
template <int kBits, int kItems>
__device__ __forceinline__ int warp_ranks(const uint32_t (&k)[kItems], int shift, int lane,
                                          int (&slot)[kItems]) {
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;  // lane r: keys of digit r in the items so far
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = (k[j] >> shift) & kMask;
    const DigitBallots<kBits> ballots(d, kBits);
    slot[j] = __shfl_sync(kFullWarp, count, d) + __popc(ballots.lanes_with(d, kBits) & below);
    count += __popc(ballots.lanes_with(lane, kBits));
  }
  return count;
}

// Rank step of the 1,024-key tile: the lane's items k, v (warp-striped:
// item j is element 32 j + lane) into the staging sk, sv at start[digit] +
// slot.  Returns lane r's count of digit r (garbage in lanes >= 2^kBits).
// The caller __syncwarp()s before it reads the staging.
template <int kBits>
__device__ __forceinline__ int rank_1k(const uint32_t (&k)[kFastItems],
                                       const uint32_t (&v)[kFastItems], int shift, int lane,
                                       uint32_t* sk, uint32_t* sv) {
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  int slot[kFastItems];
  const int count = warp_ranks<kBits>(k, shift, lane, slot);
  int total;
  const int start = warp_exclusive_scan(lane < (1 << kBits) ? count : 0, lane, total);
#pragma unroll
  for (int j = 0; j < kFastItems; ++j) {
    const uint32_t d = (k[j] >> shift) & kMask;
    const int pos = __shfl_sync(kFullWarp, start, d) + slot[j];
    sk[pos] = k[j];
    sv[pos] = v[j];
  }
  return count;
}

// Rank step of any tile (tile / 32 items a lane, radix <= 16): counts the
// tile's digits from device memory, then reads it again and stages it.
// kin, vin: the tile's element `lane`.  Returns lane r's count of digit r
// (0 in lanes >= radix); start gets its exclusive scan.
__device__ __forceinline__ int rank_any(const uint32_t* kin, const uint32_t* vin, int items,
                                        int shift, int radix, int bits, int lane,
                                        uint32_t* sk, uint32_t* sv, int& start) {
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  const unsigned below = (1u << lane) - 1u;
  int count = 0;  // lane r: keys of digit r in the tile
  for (int j = 0; j < items; ++j) {
    const DigitBallots<4> ballots((kin[32 * j] >> shift) & mask, bits);
    count += __popc(ballots.lanes_with(lane, bits));
  }
  count = lane < radix ? count : 0;
  int total;
  start = warp_exclusive_scan(count, lane, total);
  int next = start;  // lane r: the next slot of digit r in the staged tile
  for (int j = 0; j < items; ++j) {
    const uint32_t key = kin[32 * j];
    const uint32_t d = (key >> shift) & mask;
    const DigitBallots<4> ballots(d, bits);
    const int pos = __shfl_sync(kFullWarp, next, d) + __popc(ballots.lanes_with(d, bits) & below);
    next += __popc(ballots.lanes_with(lane, bits));
    sk[pos] = key;
    sv[pos] = vin[32 * j];
  }
  return count;
}

// Place step of the 1,024-key tile from registers.  Lane r < kRadix brings
// run r's length h and destination o (0 in the other lanes); k and v are
// the lane's slots 32 j + lane of the digit-major tile.
template <int kRadix>
__device__ __forceinline__ void place_1k(const uint32_t (&k)[kFastItems],
                                         const uint32_t (&v)[kFastItems], int h, int o,
                                         int lane, uint32_t* __restrict__ out_keys,
                                         uint32_t* __restrict__ out_idx, int n) {
  int total;
  const int local = warp_exclusive_scan(h, lane, total);
  const int end = local + h;  // lane r: the end of run r
  const int delta = run_delta(o, local, kFastTile);
  // end[r] - lane: item j's slot 32 j + lane lies at or past end[r] when
  // this is <= 32 j.  The last end needs no compare: a slot past it stays in
  // the last run, as the plain version's clamp keeps it.
  int ends[kRadix - 1];
#pragma unroll
  for (int r = 0; r < kRadix - 1; ++r) ends[r] = __shfl_sync(kFullWarp, end, r) - lane;
#pragma unroll
  for (int j = 0; j < kFastItems; ++j) {
    int run = 0;
#pragma unroll
    for (int r = 0; r < kRadix - 1; ++r) run += ends[r] <= 32 * j;
    const int dst = __shfl_sync(kFullWarp, delta, run) + 32 * j + lane;
    if (in_range(dst, n)) {
      out_keys[dst] = k[j];
      out_idx[dst] = v[j];
    }
  }
}

// Place step of any tile: ends and delta are the warp's rows of run ends
// and deltas (radix entries each, written before a __syncwarp); kin, vin
// the digit-major tile's slot `lane`, in device or shared memory.  Each
// lane walks its runs forward, as its slots only grow.
__device__ __forceinline__ void place_any(const uint32_t* kin, const uint32_t* vin, int items,
                                          const int* ends, const int* delta, int radix, int lane,
                                          uint32_t* __restrict__ out_keys,
                                          uint32_t* __restrict__ out_idx, int n) {
  constexpr int kBatch = 32;  // items a lane loads before it stores them
  int run = 0;
  for (int j0 = 0; j0 < items; j0 += kBatch) {
    uint32_t k[kBatch], v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {
        k[j] = kin[32 * (j0 + j)];
        v[j] = vin[32 * (j0 + j)];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j0 + j < items) {
        const int p = 32 * (j0 + j) + lane;
        while (run < radix - 1 && ends[run] <= p) ++run;
        const int dst = delta[run] + p;
        if (in_range(dst, n)) {
          out_keys[dst] = k[j];
          out_idx[dst] = v[j];
        }
      }
    }
  }
}

}  // namespace grs
