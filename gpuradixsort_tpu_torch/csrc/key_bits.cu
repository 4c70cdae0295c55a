// The AND and the OR of every key of a uint32 buffer: which key bits vary.
//
// Replaces no Pallas kernel.  The JAX package decides in each pass of its
// fused sort, on the device, whether the pass's digit takes one value over
// the padded buffer, and then skips the pass (the lax.cond predicate of
// gpuradixsort_tpu/ops/sort.py:83).  A pass permutes the keys and keeps
// their multiset, so every pass's answer is known before the first: digit p
// is constant exactly where the AND and the OR of all keys agree on its
// bits.  The port reduces the buffer once and, for a fused sort, turns the
// two words into the sort's pass plan on the card (pass_plan_kernel), which
// K1 and the fused pass (bucketize_scatter.cu) read: nothing goes back to
// the host.
//
// Bound on the H100: HBM bytes, 4 a key read once.
//
// Design: a grid-stride loop in which a thread issues kUnroll 16-byte loads
// before it combines any; the warp's AND and OR by one __reduce_and_sync and
// one __reduce_or_sync, the block's through shared memory; then one
// atomicAnd and one atomicOr a block into out[0] and out[1], which the entry
// point first sets to all-ones and to zero with two memsets on the stream.
// At most kMaxBlocks blocks, so at most 2 x kMaxBlocks atomics.  The grid
// depends on n alone and the entry point queries nothing of the device.
//
// The plan: one int32 a pass, -1 where the pass's digit is constant over
// the buffer (the pass is skipped), else source | destination << 2 over the
// sort's buffers: 0 its input, 1 its result R, 2 its scratch S (warp.cuh).
// A pass cannot scatter into the buffer it reads, since one tile's stores
// would overwrite another tile's keys before they are read, so the passes
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
constexpr int kUnroll = 4;          // 16-byte loads a thread has in flight
constexpr int64_t kMaxBlocks = 1024;  // about the blocks of 256 the H100 holds at once

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
    if (lane == 0) {
      atomicAnd(out, all);
      atomicOr(out + 1, any);
    }
  }
}

__global__ void pass_plan_kernel(const uint32_t* __restrict__ words, int num_passes,
                                 int radix_bits, int32_t* __restrict__ plan,
                                 unsigned long long* __restrict__ skipped) {
  constexpr int kInput = 0, kResult = 1, kScratch = 2;
  const uint32_t varying = words[1] & ~words[0];
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

}  // namespace

// keys: n uint32 (4-byte aligned, n >= 0); out: 2 uint32, set here to the
// AND (out[0]) and the OR (out[1]) of the keys: all-ones and zero for n = 0.
// plan: null, or num_passes int32 set here to the pass plan of a fused sort
// of the keys by radix_bits-bit digits (num_passes x radix_bits <= 32); its
// skipped passes are then added to *skipped, an 8-byte-aligned int64.
// Returns cudaGetLastError() after the launches.
extern "C" int grs_key_bits(const void* keys, int64_t n, void* out, void* plan,
                            int num_passes, int radix_bits, void* skipped, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(keys) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      (plan != nullptr &&
       (reinterpret_cast<uintptr_t>(plan) % 4 != 0 || skipped == nullptr ||
        reinterpret_cast<uintptr_t>(skipped) % 8 != 0 || num_passes < 1 ||
        radix_bits < 1 || radix_bits > 8 || num_passes * radix_bits > 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* words = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0xFF, sizeof(uint32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(words + 1, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const auto* k = static_cast<const uint32_t*>(keys);
    const int64_t head =
        std::min<int64_t>(n, (16 - reinterpret_cast<uintptr_t>(k) % 16) % 16 / 4);
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
