// The AND and the OR of every key of a uint32 buffer: which key bits vary.
//
// Replaces no Pallas kernel.  The JAX package decides in each pass of its
// fused sort, on the device, whether the pass's digit takes one value over
// the padded buffer, and then skips the pass (the lax.cond predicate of
// gpuradixsort_tpu/ops/sort.py:83).  A pass permutes the keys and keeps
// their multiset, so every pass's answer is known before the first: digit p
// is constant exactly where the AND and the OR of all keys agree on its
// bits.  The port reduces the buffer once and, for a fused sort, turns the
// two words into the sort's pass plan on the card, which K1 and the fused
// pass (bucketize_scatter.cu) read: nothing goes back to the host.
//
// Bound on the H100: HBM bytes, 4 a key read once.
//
// key_bits_kernel (key_bits and pass_plan, off the fused sort's path): a
// grid-stride loop in which a thread issues kUnroll 16-byte loads before it
// combines any; the warp's AND and OR by one __reduce_and_sync and one
// __reduce_or_sync, the block's through shared memory; then one atomicAnd
// and one atomicOr a block into out[0] and out[1], which the entry point
// first sets to all-ones and to zero with two memsets on the stream, and
// pass_plan_kernel after it.  At most kMaxBlocks blocks.  The grid depends
// on n alone and the entry point queries nothing of the device.
//
// sort_plan_kernel (grs_sort_plan, the fused sort's plan).  A fused sort
// also needs, in the same read, every pass's digit counts over the whole
// buffer: num_passes x radix counters, 8 x 16 at 4-bit digits.  The JAX
// package sums them from K1's tile histograms in every pass
// (gpuradixsort_tpu/ops/sort.py:81); a pass keeps the keys' multiset, so the
// counts of the input serve every pass, as the AND and the OR do.  From
// them each pass's digit bases follow, the exclusive prefix of its counts:
// where the pass's run of digit r starts in the output.  The fused pass
// (bucketize_scatter.cu) takes its run offsets from the bases and a
// look-back over partitions, so a pass launches one kernel and no K1 and no
// offsets scan.  Design:
//   - counting is 4 bits a counter in registers: each lane adds
//     1 << (4 x field) to a 64-bit word per 16 counters, so a key costs a
//     shift and an add a pass, and no two lanes share a counter, so skewed
//     keys (one digit holding every key) cost what random ones cost.  Every
//     round of kCountUnroll loads (12 keys a lane, within a 4-bit field's
//     15) moves the fields into 8-bit ones; every kWideRounds rounds (and at
//     the end) the warp sums those with __reduce_add_sync, and lane l adds
//     counters l, l + 32, ... to the block's shared counters with one atomic
//     instruction each.  Byte histograms in shared memory by atomics (4 a
//     key) measured slower from 2^24 keys on (PERF.md, Findings).
//   - the block adds each non-zero counter with one atomicAdd to a 128-byte
//     line of the counter's own (at most kMaxPlanBlocks blocks), and its
//     AND and OR into a line beside them.
//   - the last block to finish (a fence and a counter of finished blocks)
//     reads the sums and writes the AND and the OR, the counts, the plan
//     and each pass's bases.  So a sort's plan is one memset (the lines and
//     the look-back's scratch) and one kernel on the stream.
//   - it reads only the live keys: their address and their number come
//     from the sort's argument block (warp.cuh's SortArgs), so a graph's
//     replay reads the caller's keys where they lie, and the 16-byte
//     aligned head is found from that address on the card.  The rows from
//     the live length to the padded n are pads, PAD_KEY = all-ones: the
//     last block adds them arithmetically, one to the last digit of every
//     pass each, and sets every bit of the OR (the AND keeps its value).
//     The JAX package re-pads the buffer with jnp.where and makes the index
//     with jnp.arange before its sort (gpuradixsort_tpu/ops/sort.py:167-169,
//     :193-194, :246-247); here no pass over the buffer does either.
// The rounds are alike for every thread of the grid, so the warp sums need
// no guard.  The counts are uint32: a buffer holds at most 2^31 - block keys
// (core/table.py::check_padded_rows), so they cannot wrap.
//
// sort_args_kernel (grs_sort_args): one thread copies its by-value
// arguments, the sort's input, its result R and its live length, into the
// argument block.  The launch copies the arguments, so no host buffer is
// read while a graph replays; the fused sort launches it once a sort,
// eager or graphed, before the passes.
//
// The plan: one int32 a pass, -1 where the pass's digit is constant over
// the buffer (the pass is skipped), else source | destination << 2 over the
// sort's buffers: 0 its input, 1 its result R, 2 its scratch S (warp.cuh).
// A pass cannot scatter into the buffer it reads, since one block's stores
// would overwrite another block's keys before they are read, so the passes
// that run ping-pong between R and S.  Destinations are assigned from the
// last pass that runs backwards, R, S, R, ..., so the last one writes R;
// the first reads the input and each later one its predecessor's
// destination.  So the result is always in R, the input is never written,
// and a skipped pass moves no byte.  With no varying digit (equal keys, or
// no key) the JAX package's sort hands back its input; the port's hands
// back a new buffer, so the plan then runs the last pass from the input
// into R: its digit is constant, so it copies the input.  One thread
// computes the plan after the reduction, and adds the number of skipped
// passes (the JAX package's count, without that copy) to a counter on the
// card, which the host reads only when asked.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // 16-byte loads a thread has in flight
constexpr int64_t kMaxBlocks = 1024;  // about the blocks of 256 the H100 holds at once
constexpr int kMaxCounters = 128;     // num_passes x radix at radix_bits 1, 2 and 4
constexpr int kCountUnroll = 3;       // counting: 12 keys a lane a round, a 4-bit field holds 15
constexpr int kWideRounds = 21;       // rounds an 8-bit field holds: 21 x 12 = 252
constexpr int64_t kMaxPlanBlocks = 2 * 132;  // two blocks an SM
constexpr int kCounterStride = 32;    // words from one counter's line to the next

// The block's AND and OR of every thread's all and any, in thread 0.
__device__ __forceinline__ void block_and_or(uint32_t& all, uint32_t& any) {
  __shared__ uint32_t warp_all[kWarps], warp_any[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  all = __reduce_and_sync(grs::kFullWarp, all);
  any = __reduce_or_sync(grs::kFullWarp, any);
  if (lane == 0) {
    warp_all[warp] = all;
    warp_any[warp] = any;
  }
  __syncthreads();
  if (warp == 0) {
    all = __reduce_and_sync(grs::kFullWarp, lane < kWarps ? warp_all[lane] : ~0u);
    any = __reduce_or_sync(grs::kFullWarp, lane < kWarps ? warp_any[lane] : 0u);
  }
}

__global__ void __launch_bounds__(kThreads)
    key_bits_kernel(const uint32_t* __restrict__ keys, int64_t n, int64_t head,
                    uint32_t* __restrict__ out) {
  // keys[0, head) lie before the first 16-byte boundary, then come whole
  // quads, then fewer than 4 keys.
  const uint4* quads = reinterpret_cast<const uint4*>(keys + head);
  const int64_t num_quads = (n - head) / 4;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  uint32_t all = ~0u, any = 0u;
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < num_quads; i += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldg(quads + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      all &= q[u].x & q[u].y & q[u].z & q[u].w;
      any |= q[u].x | q[u].y | q[u].z | q[u].w;
    }
  }
  for (; i < num_quads; i += stride) {
    const uint4 q = __ldg(quads + i);
    all &= q.x & q.y & q.z & q.w;
    any |= q.x | q.y | q.z | q.w;
  }
  const int64_t tail = head + 4 * num_quads;
  if (tid < head) {
    all &= keys[tid];
    any |= keys[tid];
  }
  if (tid < n - tail) {
    all &= keys[tail + tid];
    any |= keys[tail + tid];
  }
  block_and_or(all, any);
  if (threadIdx.x == 0) {
    atomicAnd(out, all);
    atomicOr(out + 1, any);
  }
}

// The plan of a fused sort from the AND and the OR of its keys.
__device__ void write_plan(uint32_t all, uint32_t any, int num_passes, int radix_bits,
                           int32_t* __restrict__ plan, unsigned long long* __restrict__ skipped) {
  constexpr int kInput = 0, kResult = 1, kScratch = 2;
  const uint32_t varying = any & ~all;
  const uint32_t digit = (1u << radix_bits) - 1u;
  uint32_t runs = 0;  // bit p: pass p runs
  for (int p = 0; p < num_passes; ++p)
    if ((varying >> (p * radix_bits)) & digit) runs |= 1u << p;
  const int ran = __popc(runs);
  atomicAdd(skipped, static_cast<unsigned long long>(num_passes - ran));
  if (ran == 0) runs = 1u << (num_passes - 1);  // the copy
  int left = __popc(runs), source = kInput;  // left: running passes from p on
  for (int p = 0; p < num_passes; ++p) {
    if ((runs >> p) & 1u) {
      const int destination = (--left & 1) ? kScratch : kResult;
      plan[p] = source | destination << 2;
      source = destination;
    } else {
      plan[p] = -1;
    }
  }
}

__global__ void pass_plan_kernel(const uint32_t* __restrict__ words, int num_passes,
                                 int radix_bits, int32_t* __restrict__ plan,
                                 unsigned long long* __restrict__ skipped) {
  write_plan(words[0], words[1], num_passes, radix_bits, plan, skipped);
}

// A lane's digit counters for every pass of kBits-bit digits: counter
// c = pass x radix + digit is the 4-bit field c % 16 of nibbles[c / 16],
// and the 8-bit fields of wide[0] (even nibbles) and wide[1] (odd ones).
template <int kBits>
struct DigitCounters {
  static constexpr int kRadix = 1 << kBits;
  static constexpr int kMaxPasses = 32 / kBits;
  static constexpr int kCounters = kMaxPasses * kRadix;
  static constexpr int kWords = kCounters / 16;
  static constexpr unsigned long long kLowNibbles = 0x0F0F0F0F0F0F0F0Full;
  static_assert(kCounters <= kMaxCounters && kCounters % 32 == 0, "counters fill the lanes");

  unsigned long long nibbles[kWords] = {};
  unsigned long long wide[2][kWords] = {};

  // One more key: its digit of each of the num_passes passes.
  __device__ __forceinline__ void add(uint32_t key, int num_passes) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < num_passes) {
        constexpr int kPerWord = 16 / kRadix;  // passes a word counts
        const uint32_t d = (key >> (p * kBits)) & (kRadix - 1);
        nibbles[p / kPerWord] += 1ull << (4 * ((p % kPerWord) * kRadix + d));
      }
    }
  }

  // The 4-bit fields into the 8-bit ones.
  __device__ __forceinline__ void widen() {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      wide[0][w] += nibbles[w] & kLowNibbles;
      wide[1][w] += (nibbles[w] >> 4) & kLowNibbles;
      nibbles[w] = 0;
    }
  }

  // The warp's sums of the 8-bit fields into the block's counters, and
  // clears the fields.  Lane l gathers counters l, l + 32, ... and adds them
  // with one shared atomic instruction each, all 32 lanes on 32 neighbouring
  // words.  All 32 lanes call it.
  __device__ __forceinline__ void flush(uint32_t* block, int lane) {
    uint32_t mine[kCounters / 32] = {};
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t x = static_cast<uint32_t>(wide[odd][w] >> (32 * h));
          // Bytes 0 and 2, then 1 and 3, as 16-bit pairs: sums <= 32 x 255.
          const uint32_t pairs[2] = {__reduce_add_sync(grs::kFullWarp, x & 0x00ff00ffu),
                                     __reduce_add_sync(grs::kFullWarp, (x >> 8) & 0x00ff00ffu)};
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            // Byte b of half h is the 8-bit field 4 h + b: nibble 2 (4 h + b) + odd.
            const int c = 16 * w + 2 * (4 * h + b) + odd;
            if (lane == c % 32) mine[c / 32] = (pairs[b & 1] >> (16 * (b >> 1))) & 0xffffu;
          }
        }
        wide[odd][w] = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kCounters / 32; ++i) atomicAdd(block + 32 * i + lane, mine[i]);
  }
};

// Keys before the first 16-byte boundary, read one by one.
__host__ __device__ inline int64_t head_of(const void* keys, int64_t n) {
  const auto head = static_cast<int64_t>((16 - reinterpret_cast<uintptr_t>(keys) % 16) % 16 / 4);
  return head < n ? head : n;
}

// zeroed (cleared before the launch): the counts table (num_passes x radix),
// then a 128-byte line a counter (lines[c x kCounterStride]), then the sync
// line: the OR of the keys' complements, the OR of the keys, the blocks
// finished.  words: the AND and the OR; plan: the plan, then the bases.
// args: the sort's argument block, whose keys and length are the live keys;
// n: the padded length.
template <int kBits>
__global__ void __launch_bounds__(kThreads)
    sort_plan_kernel(const grs::SortArgs* __restrict__ args, int64_t n,
                     uint32_t* __restrict__ words, uint32_t* __restrict__ zeroed, int num_passes,
                     int32_t* __restrict__ plan, unsigned long long* __restrict__ skipped) {
  using Counters = DigitCounters<kBits>;
  constexpr int kRadix = 1 << kBits;
  __shared__ uint32_t block[Counters::kCounters];
  __shared__ uint32_t totals[Counters::kCounters];
  __shared__ bool last;
  const int counters = num_passes * kRadix;
  uint32_t* counts = zeroed;
  uint32_t* lines = zeroed + counters;
  uint32_t* sync = lines + kMaxCounters * kCounterStride;
  for (int c = threadIdx.x; c < Counters::kCounters; c += kThreads) block[c] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const uint32_t* keys = args->keys;
  const int64_t live = args->length;  // alike in every thread, so are the rounds
  const int64_t head = head_of(keys, live);
  const uint4* quads = reinterpret_cast<const uint4*>(keys + head);
  const int64_t num_quads = (live - head) / 4;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t per_round = kCountUnroll * stride;
  const int64_t rounds = (num_quads + per_round - 1) / per_round;  // alike in every thread
  Counters tally;
  uint32_t all = ~0u, any = 0u;
  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t i = r * per_round + tid;
    uint4 q[kCountUnroll];
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u)
      if (i + u * stride < num_quads) q[u] = __ldg(quads + i + u * stride);
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      if (i + u * stride < num_quads) {
        all &= q[u].x & q[u].y & q[u].z & q[u].w;
        any |= q[u].x | q[u].y | q[u].z | q[u].w;
        tally.add(q[u].x, num_passes);
        tally.add(q[u].y, num_passes);
        tally.add(q[u].z, num_passes);
        tally.add(q[u].w, num_passes);
      }
    }
    tally.widen();
    if ((r + 1) % kWideRounds == 0) tally.flush(block, lane);
  }
  const int64_t tail = head + 4 * num_quads;
  if (tid < head) {
    all &= keys[tid];
    any |= keys[tid];
    tally.add(keys[tid], num_passes);
  }
  if (tid < live - tail) {
    all &= keys[tail + tid];
    any |= keys[tail + tid];
    tally.add(keys[tail + tid], num_passes);
  }
  tally.widen();  // at most 20 rounds and 2 keys since the last flush: 242
  tally.flush(block, lane);
  block_and_or(all, any);  // its barrier also orders the block's counters
  if (threadIdx.x == 0) {
    atomicOr(sync, ~all);
    atomicOr(sync + 1, any);
  }
  for (int c = threadIdx.x; c < counters; c += kThreads)
    if (block[c] != 0u) atomicAdd(lines + c * kCounterStride, block[c]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sync + 2, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every other block's sums are in.  The pad rows are
  // PAD_KEY, in the last digit of every pass.
  __threadfence();
  const auto pads = static_cast<uint32_t>(n - live);
  for (int c = threadIdx.x; c < counters; c += kThreads) {
    totals[c] = grs::load_status(lines + c * kCounterStride) +
                (c % kRadix == kRadix - 1 ? pads : 0u);
    counts[c] = totals[c];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < counters; c += kThreads) {
    uint32_t base = 0;
    for (int j = c - c % kRadix; j < c; ++j) base += totals[j];
    plan[num_passes + c] = static_cast<int32_t>(base);
  }
  if (threadIdx.x == 0) {
    all = ~grs::load_status(sync);
    any = grs::load_status(sync + 1) | (pads != 0u ? grs::kPadKey : 0u);
    words[0] = all;
    words[1] = any;
    write_plan(all, any, num_passes, kBits, plan, skipped);
  }
}

template <int kBits>
void launch_plan(const grs::SortArgs* args, int64_t n, uint32_t* words, uint32_t* zeroed,
                 int num_passes, int32_t* plan, unsigned long long* skipped, cudaStream_t s) {
  // The grid is the padded length's, so a graph serves every live length.
  const int64_t per_block = static_cast<int64_t>(kThreads) * kCountUnroll;
  const int64_t blocks = std::clamp<int64_t>((n / 4 + per_block - 1) / per_block, 1,
                                             kMaxPlanBlocks);
  sort_plan_kernel<kBits><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      args, n, words, zeroed, num_passes, plan, skipped);
}

__global__ void sort_args_kernel(grs::SortArgs* __restrict__ block, grs::SortArgs args) {
  *block = args;
}

bool plan_args(const void* keys, int64_t n, const void* out, const void* plan, int num_passes,
               int radix_bits, const void* skipped) {
  return n >= 0 && reinterpret_cast<uintptr_t>(keys) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
         (plan == nullptr ||
          (reinterpret_cast<uintptr_t>(plan) % 4 == 0 && skipped != nullptr &&
           reinterpret_cast<uintptr_t>(skipped) % 8 == 0 && num_passes >= 1 &&
           radix_bits >= 1 && radix_bits <= 8 && num_passes * radix_bits <= 32));
}

}  // namespace

// keys: n uint32 (4-byte aligned, n >= 0); out: 2 uint32, set here to the
// AND (out[0]) and the OR (out[1]) of the keys: all-ones and zero for n = 0.
// plan: null, or num_passes int32 set here to the pass plan of a fused sort
// of the keys by radix_bits-bit digits (num_passes x radix_bits <= 32); its
// skipped passes are then added to *skipped, an 8-byte-aligned int64.
// Returns cudaGetLastError() after the launches.
extern "C" int grs_key_bits(const void* keys, int64_t n, void* out, void* plan, int num_passes,
                            int radix_bits, void* skipped, void* stream) {
  if (!plan_args(keys, n, out, plan, num_passes, radix_bits, skipped))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0xFF, sizeof(uint32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(words + 1, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const auto* k = static_cast<const uint32_t*>(keys);
    const int64_t head = head_of(k, n);
    const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
    const int64_t blocks =
        std::clamp<int64_t>(((n - head) / 4 + per_block - 1) / per_block, 1, kMaxBlocks);
    key_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(k, n, head, words);
  }
  if (plan != nullptr) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pass_plan_kernel<<<1, 1, 0, s>>>(words, num_passes, radix_bits, static_cast<int32_t*>(plan),
                                     static_cast<unsigned long long*>(skipped));
  }
  return static_cast<int>(cudaGetLastError());
}

// A fused sort's plan.  args: the sort's argument block (grs_sort_args,
// 8-byte aligned), whose keys and length are the live keys; n: the padded
// length, 0 <= length <= n, the rows from the length on counted as PAD_KEY;
// out, num_passes and skipped as grs_key_bits' (radix_bits 1, 2 or 4); plan:
// num_passes int32 set to the plan, then num_passes x radix int32 set to
// each pass's digit bases (the exclusive prefix of its counts).  zeroed:
// the start of zeroed_bytes bytes (8-byte aligned) that this call clears on
// the stream: first num_passes x radix uint32, set to every pass's digit
// counts over the padded keys (counts[p x radix + r]: keys whose digit p is
// r), then (kMaxCounters + 1) x kCounterStride uint32 in which the kernel
// sums them (COUNT_LINES), then whatever the caller wants cleared with them
// (a fused sort's look-back words).  One memset and one launch, whose grid
// depends on n alone; returns cudaGetLastError() after them.
extern "C" int grs_sort_plan(const void* args, int64_t n, void* out, void* plan, int num_passes,
                             int radix_bits, void* skipped, void* zeroed, int64_t zeroed_bytes,
                             void* stream) {
  if (args == nullptr || reinterpret_cast<uintptr_t>(args) % 8 != 0 ||
      !plan_args(args, n, out, plan, num_passes, radix_bits, skipped) || plan == nullptr ||
      zeroed == nullptr || (radix_bits != 1 && radix_bits != 2 && radix_bits != 4) ||
      reinterpret_cast<uintptr_t>(zeroed) % 8 != 0 ||
      zeroed_bytes < 4 * (static_cast<int64_t>(num_passes) * (1 << radix_bits) +
                          (kMaxCounters + 1) * kCounterStride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(zeroed, 0, static_cast<size_t>(zeroed_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = static_cast<const grs::SortArgs*>(args);
  auto* w = static_cast<uint32_t*>(out);
  auto* z = static_cast<uint32_t*>(zeroed);
  auto* p = static_cast<int32_t*>(plan);
  auto* skip = static_cast<unsigned long long*>(skipped);
  if (radix_bits == 1) {
    launch_plan<1>(a, n, w, z, num_passes, p, skip, s);
  } else if (radix_bits == 2) {
    launch_plan<2>(a, n, w, z, num_passes, p, skip, s);
  } else {
    launch_plan<4>(a, n, w, z, num_passes, p, skip, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// A fused sort's argument block.  block: room for a grs::SortArgs (five
// 8-byte words, 8-byte aligned), set here on the stream to the sort's input
// keys and idx (null: the sort makes the index), its result out_keys and
// out_idx (null where the launches that read the block write no result)
// and its live length, 0 <= length <= n, the padded keys.  keys is null
// only for no key (an empty buffer); every pointer is 4-byte aligned.  One launch of one thread, whose
// arguments are copied at the launch.  Returns cudaGetLastError() after it.
extern "C" int grs_sort_args(void* block, const void* keys, const void* idx, void* out_keys,
                             void* out_idx, int64_t length, int64_t n, void* stream) {
  const void* const words[] = {keys, idx, out_keys, out_idx};
  bool aligned = block != nullptr && reinterpret_cast<uintptr_t>(block) % 8 == 0;
  for (const void* w : words) aligned = aligned && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  if (!aligned || (keys == nullptr && n > 0) || length < 0 || length > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const grs::SortArgs args{static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(idx),
                           static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(out_idx),
                           length};
  sort_args_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<grs::SortArgs*>(block), args);
  return static_cast<int>(cudaGetLastError());
}
