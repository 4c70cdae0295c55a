// K5: exclusive prefix sum of an int32 vector, and its total.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/scan.py::_scan_kernel
// (called by _exclusive_scan_2d and exclusive_scan).  out[i] = x[0] + ... +
// x[i - 1] and total = x[0] + ... + x[n - 1], both modulo 2^32 as int32 sums
// wrap in jnp.cumsum.  The kernel adds in uint32_t, where wrapping is
// defined.
//
// Bound on the H100: HBM bytes.  x is read once and out written once, 8
// bytes an element.
//
// Design: one pass with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA, 2016).  The TPU
// kernel walks the tiles in grid order and carries the running sum in SMEM;
// Hopper blocks run in no order, so each block takes the next chunk of
// kThreads x kItems elements from a global counter (a block never waits on a
// chunk that no resident block holds), and:
//   1. loads the chunk warp by warp with 16-byte loads where x is 16-byte
//      aligned (4-byte loads otherwise and at the ragged edge), a lane
//      issuing all its loads before it uses any, into shared memory, from
//      which each thread reads kItems consecutive elements into registers;
//   2. sums its chunk over the block;
//   3. publishes the chunk's sum in a 64-bit status word that holds the tag
//      and the value together (warp.cuh's status words, which the fused
//      sort's pass shares), read and written relaxed at gpu scope (acquire
//      and release were timed no faster; PERF.md, Findings);
//   4. warp 0 looks back 32 predecessors at a time: one ballot over their
//      tags finds the nearest one that holds an inclusive prefix, and one
//      warp sum adds the chunk sums up to it.  The block then publishes its
//      own inclusive prefix;
//   5. scans its registers from that prefix and stores the chunk through
//      shared memory with 16-byte stores.  The last chunk writes the total.
// A tag is 1 (the chunk's sum) or 2 (its inclusive prefix); 0 reads as not
// ready.  Each call clears the counter and the status words with one memset
// before its launch, so no word of an earlier call is read and the call is
// safe under CUDA graph capture.  An input of one chunk takes no ticket,
// publishes nothing and needs no memset.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kWarps = 8;  // chunks of 8,192
constexpr int kThreads = 32 * kWarps;
constexpr int kItems = 32;                 // elements a thread scans
constexpr int kSpan = 32 * kItems;         // elements of a warp's span of the chunk
constexpr int kChunk = kWarps * kSpan;     // elements a block

// Shared index of element i of a warp's span, padded by one word per 32 so
// that the per-thread runs of kItems words fall on distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

constexpr size_t kSharedBytes = kWarps * padded(kSpan) * sizeof(uint32_t);
static_assert(kSharedBytes <= 48 * 1024, "within the default dynamic shared memory");

constexpr uint32_t kSum = 1u;
constexpr uint32_t kInclusive = 2u;

// Warp 0 of chunk c (> 0): publishes the chunk's sum, waits for and adds the
// sums of its predecessors back to the nearest inclusive prefix, publishes
// its own inclusive prefix and returns its exclusive one (in every lane).
__device__ uint32_t look_back(unsigned long long* status, int64_t c, uint32_t sum, int lane) {
  if (lane == 0) grs::store_status(status + c, grs::status_word(kSum, sum));
  uint32_t prefix = 0;
  for (int64_t end = c;; end -= 32) {
    const int64_t i = end - 1 - lane;  // lane 0 is the nearest predecessor
    unsigned long long s;
    do {
      s = i >= 0 ? grs::load_status(status + i) : grs::status_word(kInclusive, 0u);
    } while (__any_sync(grs::kFullWarp, static_cast<uint32_t>(s >> 32) < kSum));
    const unsigned inclusive =
        __ballot_sync(grs::kFullWarp, static_cast<uint32_t>(s >> 32) == kInclusive);
    uint32_t v = static_cast<uint32_t>(s);
    if (inclusive != 0u && lane > __ffs(inclusive) - 1) v = 0u;
    prefix += __reduce_add_sync(grs::kFullWarp, v);
    if (inclusive != 0u) break;
  }
  if (lane == 0) grs::store_status(status + c, grs::status_word(kInclusive, prefix + sum));
  return prefix;
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const uint32_t* __restrict__ x, int64_t n, uint32_t* __restrict__ out,
                unsigned long long* status, unsigned int* counter, int64_t num_chunks,
                bool vec) {
  extern __shared__ uint32_t spans[];  // [kWarps][padded(kSpan)]
  __shared__ uint32_t warp_base[kWarps];
  __shared__ int64_t ticket;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* span = spans + warp * padded(kSpan);

  int64_t c = 0;
  if (num_chunks > 1) {
    if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
    __syncthreads();
    c = ticket;
  }
  const int64_t first = c * kChunk + warp * kSpan;
  const bool whole = first + kSpan <= n;  // alike in every lane of the warp
  uint4 q[kItems / 4];  // every load is issued before the first is used
  if (vec && whole) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j)
      q[j] = __ldg(reinterpret_cast<const uint4*>(x + first + 4 * (32 * j + lane)));
  } else {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int64_t g = first + 4 * (32 * j + lane);
      q[j].x = g < n ? __ldg(x + g) : 0u;
      q[j].y = g + 1 < n ? __ldg(x + g + 1) : 0u;
      q[j].z = g + 2 < n ? __ldg(x + g + 2) : 0u;
      q[j].w = g + 3 < n ? __ldg(x + g + 3) : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) {
    const int e = 4 * (32 * j + lane);
    span[padded(e)] = q[j].x;
    span[padded(e + 1)] = q[j].y;
    span[padded(e + 2)] = q[j].z;
    span[padded(e + 3)] = q[j].w;
  }
  __syncwarp();
  uint32_t v[kItems];
  uint32_t local = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = span[padded(lane * kItems + i)];
    local += v[i];
  }
  uint32_t warp_sum;
  const uint32_t excl = grs::warp_exclusive_scan(local, lane, warp_sum);
  if (lane == 0) warp_base[warp] = warp_sum;
  __syncthreads();
  if (warp == 0) {
    uint32_t sum;
    const uint32_t w = grs::warp_exclusive_scan(lane < kWarps ? warp_base[lane] : 0u, lane, sum);
    uint32_t prefix = 0;
    if (c == 0) {
      if (lane == 0 && num_chunks > 1)
        grs::store_status(status, grs::status_word(kInclusive, sum));
    } else {
      prefix = look_back(status, c, sum, lane);
    }
    if (lane < kWarps) warp_base[lane] = prefix + w;
    if (lane == 0 && c == num_chunks - 1) out[n] = prefix + sum;
  }
  __syncthreads();
  uint32_t run = warp_base[warp] + excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    span[padded(lane * kItems + i)] = run;
    run += v[i];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) {
    const int e = 4 * (32 * j + lane);
    const int64_t g = first + e;
    const uint4 r = make_uint4(span[padded(e)], span[padded(e + 1)], span[padded(e + 2)],
                               span[padded(e + 3)]);
    if (whole || g + 3 < n) {
      *reinterpret_cast<uint4*>(out + g) = r;
    } else {
      if (g < n) out[g] = r.x;
      if (g + 1 < n) out[g + 1] = r.y;
      if (g + 2 < n) out[g + 2] = r.z;
    }
  }
}

}  // namespace

// x: n int32 (n >= 1).  out: n + 1 int32, 16-byte aligned: the scan, then
// the total.  chunk: elements a block scans, which must be the kernel's, as
// the caller sizes the scratch by it.  scratch: 8-byte aligned, num_chunks +
// 1 64-bit words (num_chunks = ceil(n / chunk)): the chunk counter, then the
// status words, cleared here on the stream.  Returns cudaGetLastError()
// after the launch.
extern "C" int grs_exclusive_scan(const void* x, void* out, int64_t n, int chunk,
                                  void* scratch, void* stream) {
  if (n < 1 || chunk != kChunk || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t num_chunks = (n + kChunk - 1) / kChunk;
  auto* words = static_cast<unsigned long long*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (num_chunks > 1) {
    const cudaError_t err =
        cudaMemsetAsync(words, 0, (num_chunks + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<static_cast<unsigned>(num_chunks), kThreads, kSharedBytes, s>>>(
      static_cast<const uint32_t*>(x), n, static_cast<uint32_t*>(out), words + 1,
      reinterpret_cast<unsigned int*>(words), num_chunks,
      reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
