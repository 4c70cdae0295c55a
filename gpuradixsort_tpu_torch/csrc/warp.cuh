// Warp-level helpers shared by the kernels of this directory.
#pragma once

#include <cstdint>

namespace grs {

constexpr unsigned kFullWarp = 0xffffffffu;

// The ballots of one digit per lane, one per digit bit (bits <= MaxBits), from
// which any lane can find the lanes holding any digit: its own (the peers it
// ranks among) and, in K2 and K4, the digit equal to its lane number (whose
// count or destination that lane keeps).  All 32 lanes must construct it.  On
// the H100 ballots per digit bit measured faster than __match_any_sync, which
// bounded K1 and K2 (PERF.md, Findings).
template <int MaxBits>
struct DigitBallots {
  unsigned ones[MaxBits];

  __device__ __forceinline__ DigitBallots(uint32_t d, int bits) {
#pragma unroll
    for (int b = 0; b < MaxBits; ++b)
      ones[b] = b < bits ? __ballot_sync(kFullWarp, (d >> b) & 1u) : 0u;
  }

  // The lanes whose digit equals x.
  __device__ __forceinline__ unsigned lanes_with(uint32_t x, int bits) const {
    unsigned m = kFullWarp;
#pragma unroll
    for (int b = 0; b < MaxBits; ++b)
      if (b < bits) m &= ((x >> b) & 1u) ? ones[b] : ~ones[b];
    return m;
  }
};

// Exclusive prefix sum of x over the 32 lanes of a warp; total gets the sum.
// All 32 lanes must call it.  With T = uint32_t the sums wrap modulo 2^32.
template <typename T>
__device__ inline T warp_exclusive_scan(T x, int lane, T& total) {
  T incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += y;
  }
  total = __shfl_sync(kFullWarp, incl, 31);
  return incl - x;
}

}  // namespace grs
