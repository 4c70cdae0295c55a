// Warp-level helpers shared by the kernels of this directory.
#pragma once

#include <cstdint>

namespace grs {

// The lanes of the calling warp whose digit equals d, with one ballot per
// digit bit.  All 32 lanes must call it.  On the H100 this measured faster
// than __match_any_sync, which bounded K1 and K2 (PERF.md, Findings).
__device__ inline unsigned lanes_with_digit(uint32_t d, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const unsigned ones = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? ones : ~ones;
  }
  return peers;
}

// Exclusive prefix sum of x over the 32 lanes of a warp; total gets the sum.
// All 32 lanes must call it.  With T = uint32_t the sums wrap modulo 2^32.
template <typename T>
__device__ inline T warp_exclusive_scan(T x, int lane, T& total) {
  T incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - x;
}

}  // namespace grs
