// Warp-level helpers shared by the kernels of this directory.
#pragma once

#include <cstdint>

namespace grs {

constexpr unsigned kFullWarp = 0xffffffffu;

// The buffers of a fused sort: 0 its input, 1 its result R, 2 its scratch S.
// Pass `pass` of a planned sort (sort_plan.cu writes the plan) reads its
// keys from `source` and writes them to `destination`; source -1 where the
// plan skips the pass.  A plan entry is -1, or source | destination << 2
// (kernels/sort_plan.py::plan_entry).  Without a plan (a look-back pass on
// its own) a launch reads buffer 0 and writes buffer 1.
struct Route {
  int source, destination;
};

__device__ __forceinline__ Route plan_route(const int32_t* plan, int pass) {
  if (plan == nullptr) return {0, 1};
  const int e = plan[pass];
  return e < 0 ? Route{-1, -1} : Route{e & 3, e >> 2};
}

constexpr uint32_t kPadKey = 0xFFFFFFFFu;    // config.PAD_KEY
constexpr uint32_t kPadIndex = 0xFFFFFFFFu;  // config.PAD_INDEX

// A fused sort's per-call inputs, its argument block on the card.
// sort_plan.cu's grs_sort_args writes it before each sort, outside any
// graph, and sort_plan_kernel and the look-back pass (bucketize_scatter.cu)
// read their input and the result R from it, so a captured sort reads the
// caller's keys where they lie and writes a result the caller owns.  Rows
// of the input at or past `length` are pad rows: they read as PAD_KEY, and
// their index as PAD_INDEX.  idx is null where the sort makes the index:
// element e's is e below `length`.
struct SortArgs {
  const uint32_t* keys;
  const uint32_t* idx;
  uint32_t* out_keys;
  uint32_t* out_idx;
  int64_t length;
};
static_assert(sizeof(SortArgs) == 40, "five 8-byte words (sort_plan.py::ARGS_WORDS)");

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

// Status words of a decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA, 2016): a 64-bit
// word holds a tag in its high half and a value in its low half, so that
// one access moves both.  Nothing else is published through a word, so
// relaxed loads and stores at gpu scope suffice.  K5 (scan.cu) looks back
// across chunks, the fused sort's pass (bucketize_scatter.cu) across
// partitions.
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(uint32_t tag, uint32_t value) {
  return (static_cast<unsigned long long>(tag) << 32) | value;
}

// A 32-bit status word, where the tag and the value fit in one.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

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

// Four words from device memory to shared memory, asynchronously: one 16-byte
// copy where both addresses allow it (vec), else four 4-byte copies.
__device__ __forceinline__ void cp_async(uint32_t* smem, const uint32_t* gmem, bool vec) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * i),
                   "l"(gmem + i) : "memory");
  }
}

// Tile t's keys and indices (kTile each) into a warp's input buffer, keys
// first, in element order, as one cp.async group.  Wait with
// cp.async.wait_group, then __syncwarp, before reading the buffer.
template <int kTile>
__device__ __forceinline__ void load_tile(uint32_t* in, const uint32_t* keys,
                                          const uint32_t* idx, int64_t t, int lane,
                                          bool vec) {
  const int64_t base = t * kTile;
#pragma unroll
  for (int i = 0; i < kTile / 128; ++i) {
    const int e = 4 * (lane + 32 * i);
    cp_async(in + e, keys + base + e, vec);
    cp_async(in + kTile + e, idx + base + e, vec);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace grs
