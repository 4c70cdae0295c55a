// The fused sort's pass: bucketize and scatter (K2 then K3) as one kernel.
//
// Replaces, on the fused sort's main path, the pair of Pallas kernels
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel and
// gpuradixsort_tpu/kernels/scatter.py::_window_kernel, which one fused pass
// runs one after the other (gpuradixsort_tpu/ops/sort.py:88-92).  The output
// equals scatter_runs(bucketize_tiles(keys, idx, shift), hist, offsets) for
// hist the tiles' digit histograms (K1's): tile t's digit-r run, stably in
// element order, goes to out[offsets[t, r] ...].
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once, plus each tile's offsets row.  The TPU pair writes the
// bucketized tiles to HBM and reads them back, because the TPU has no random
// store; K2 and K3 ported that boundary and moved 32 bytes a key between
// them.  Here the bucketized tile stays in the warp's shared memory.
//
// Design: one warp a tile and no block barrier, as K2 and K3.  For the
// default 1,024-key tile (bucketize_scatter_1k_kernel) a warp
//   1. loads the tile warp-striped into registers (32 keys and 32 indices a
//      lane, all loads issued before the first is used), and lane r < radix
//      its entry of the tile's offsets row;
//   2. ranks it with one ballot per digit bit and stages it digit-major in
//      shared memory (grs::rank_1k, K2's step); lane r ends with the tile's
//      count of digit r, so hist is not read;
//   3. reads the staging back warp-striped and stores slot p at
//      offsets[t, r] - start[r] + p (grs::place_1k, K3's step): a store
//      instruction covers 32 neighbouring slots, one or two runs.
// The warps are not persistent, one tile a warp, as in K3: run r of tile t
// and of tile t + 1 share a 32-byte sector of the output, and tiles placed
// close in time meet in L2; persistent warps with K2's cp.async prefetch of
// the next tile measured slower (PERF.md, Findings).  Any other tile
// (bucketize_scatter_any_kernel) counts the tile from device memory, reads
// it again to stage it (grs::rank_any) and places it from the staging
// (grs::place_any).  A destination outside [0, n), possible only for an
// inconsistent offsets table, is dropped, as in K3.
//
// Buffers: a launch reads (keys, idx) from buffer `source` and writes buffer
// `destination` of {input, out, scratch}.  Without a plan it reads the input
// and writes out.  In a fused sort it follows the sort's pass plan
// (key_bits.cu): a skipped pass returns at once, and a pass that runs reads
// the input, the result R (out) or the scratch S and writes R or S, never
// the buffer it reads: one tile's stores would land on another tile's keys
// before that tile had read them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kMaxRadix = 16;
constexpr int kFastTile = grs::kFastTile;
constexpr int kItems = grs::kFastItems;
constexpr int kMaxWarps = 8;        // tiles a block
constexpr int kMaxShared = 232448;  // shared memory a block may use (H100)

// The sort's buffers: 0 the input, 1 the result (or an unplanned launch's
// output), 2 the scratch.  The input is only read.
struct Buffers {
  uint32_t* keys[3];
  uint32_t* idx[3];
};

// Buffer i's keys and indices, chosen by compares: indexing the kernel
// parameter with a value known only at run time would copy it to the stack.
struct Pair {
  uint32_t* keys;
  uint32_t* idx;
};

__device__ __forceinline__ Pair buffer(const Buffers& b, int i) {
  return i == 0 ? Pair{b.keys[0], b.idx[0]}
                : (i == 1 ? Pair{b.keys[1], b.idx[1]} : Pair{b.keys[2], b.idx[2]});
}

// Words of shared memory a warp keeps: the staged tile, and off the fast
// route also the rows of run ends and deltas.
__host__ __device__ constexpr int warp_words(int tile, bool fast) {
  return fast ? 2 * kFastTile : 2 * tile + 2 * kMaxRadix;
}

// Steps 2 and 3 of one 1,024-key tile held in k, v; o is lane r's offsets
// entry.  The outputs come in as __restrict__ parameters: with this body
// written into the kernel, where they are not, the kernel took 6-9% longer
// at 2^24 and 100M keys on the H100 (PERF.md, Findings).
template <int kBits>
__device__ __forceinline__ void rank_and_place(uint32_t (&k)[kItems], uint32_t (&v)[kItems],
                                               int o, int shift, int lane, uint32_t* sk,
                                               uint32_t* sv, uint32_t* __restrict__ out_keys,
                                               uint32_t* __restrict__ out_idx, int n) {
  constexpr int kRadix = 1 << kBits;
  const int count = grs::rank_1k<kBits>(k, v, shift, lane, sk, sv);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_generic(sk + 32 * j + lane);
    v[j] = grs::load_generic(sv + 32 * j + lane);
  }
  grs::place_1k<kRadix>(k, v, lane < kRadix ? count : 0, o, lane, out_keys, out_idx, n);
}

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_1k_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                int shift, int n) {
  constexpr int kRadix = 1 << kBits;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const grs::Route route = grs::plan_route(plan, pass);
  if (t >= num_tiles || route.source < 0) return;  // no block barrier follows
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(kFastTile, true);
  uint32_t* sv = sk + kFastTile;
  uint32_t k[kItems], v[kItems];
  const int o = lane < kRadix ? offsets[t * kRadix + lane] : 0;
  const uint32_t* kin = in.keys + t * kFastTile + lane;
  const uint32_t* vin = in.idx + t * kFastTile + lane;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = grs::load_global(kin + 32 * j);
    v[j] = grs::load_global(vin + 32 * j);
  }
  rank_and_place<kBits>(k, v, o, shift, lane, sk, sv, out.keys, out.idx, n);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_scatter_any_kernel(Buffers b, const int32_t* __restrict__ offsets,
                                 const int32_t* __restrict__ plan, int pass, int64_t num_tiles,
                                 int tile, int shift, int radix, int bits, int n) {
  extern __shared__ uint4 smem[];  // per warp: the staged tile, then run ends and deltas
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const grs::Route route = grs::plan_route(plan, pass);
  if (t >= num_tiles || route.source < 0) return;  // no block barrier follows

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) +
                 static_cast<size_t>(warp) * warp_words(tile, false);
  uint32_t* sv = sk + tile;
  int* ends = reinterpret_cast<int*>(sv + tile);
  int* delta = ends + kMaxRadix;
  const int64_t base = t * tile;
  int start;
  const Pair in = buffer(b, route.source), out = buffer(b, route.destination);
  const int count = grs::rank_any(in.keys + base + lane, in.idx + base + lane, tile >> 5, shift,
                                  radix, bits, lane, sk, sv, start);
  if (lane < radix) {
    ends[lane] = start + count;
    delta[lane] = grs::run_delta(offsets[t * radix + lane], start, tile);
  }
  __syncwarp();
  grs::place_any(sk + lane, sv + lane, tile >> 5, ends, delta, radix, lane, out.keys, out.idx, n);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One block per threads / 32 tiles.
template <int kBits>
cudaError_t launch_1k(const Buffers& b, const int32_t* offsets, const int32_t* plan, int pass,
                      int64_t num_tiles, int threads, size_t smem, int shift, int n,
                      cudaStream_t stream) {
  const auto kernel = bucketize_scatter_1k_kernel<kBits>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t per_block = threads / 32;
  const int64_t blocks = (num_tiles + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(b, offsets, plan, pass,
                                                                   num_tiles, shift, n);
  return cudaSuccess;
}

}  // namespace

// keys, idx: the input, num_tiles * tile uint32 (4-byte aligned); offsets:
// (num_tiles, radix) int32 (global_offsets of the tiles' histograms).
// out_keys, out_idx: the output, or a planned sort's result R;
// scratch_keys, scratch_idx: null, or a planned sort's scratch S; all of
// the input's length, and no two of the buffers overlap.  One warp per tile:
// threads is 32 x the tiles of a block, at most 32 x 8; a warp keeps 8 x
// tile + 128 bytes of shared memory (8 KB on the 1,024-key tile), a block at
// most 232,448.  tile is a multiple of 128, radix a power of two from 2 to
// 16, and num_tiles * tile at most INT_MAX - tile (int32 destinations).
// plan: null, or a fused sort's pass plan on the device, of which entry
// `pass` routes this launch.  Returns cudaGetLastError() after the launch.
extern "C" int grs_bucketize_scatter(const void* keys, const void* idx, const void* offsets,
                                     void* out_keys, void* out_idx, void* scratch_keys,
                                     void* scratch_idx, int64_t num_tiles, int tile, int threads,
                                     int shift, int radix, const void* plan, int pass,
                                     void* stream) {
  const bool fast = tile == kFastTile;
  const size_t smem = static_cast<size_t>(threads / 32) * warp_words(tile, fast) *
                      sizeof(uint32_t);
  const void* buffers[] = {keys, idx, out_keys, out_idx, scratch_keys, scratch_idx};
  bool words = true;
  for (const void* p : buffers) words = words && aligned(p, 4);
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 || threads < 32 ||
      threads % 32 != 0 || threads > 32 * kMaxWarps || tile <= 0 || tile % 128 != 0 ||
      num_tiles < 0 || (num_tiles > 0 && num_tiles > (INT_MAX - tile) / tile) ||
      smem > kMaxShared || !words ||
      (plan != nullptr && (pass < 0 || scratch_keys == nullptr || scratch_idx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const Buffers b{{const_cast<uint32_t*>(static_cast<const uint32_t*>(keys)),
                   static_cast<uint32_t*>(out_keys), static_cast<uint32_t*>(scratch_keys)},
                  {const_cast<uint32_t*>(static_cast<const uint32_t*>(idx)),
                   static_cast<uint32_t*>(out_idx), static_cast<uint32_t*>(scratch_idx)}};
  const auto* o = static_cast<const int32_t*>(offsets);
  const auto* pl = static_cast<const int32_t*>(plan);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(num_tiles * tile);
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  cudaError_t err = cudaSuccess;
  if (fast) {
    switch (bits) {
      case 1: err = launch_1k<1>(b, o, pl, pass, num_tiles, threads, smem, shift, n, s); break;
      case 2: err = launch_1k<2>(b, o, pl, pass, num_tiles, threads, smem, shift, n, s); break;
      case 3: err = launch_1k<3>(b, o, pl, pass, num_tiles, threads, smem, shift, n, s); break;
      default: err = launch_1k<4>(b, o, pl, pass, num_tiles, threads, smem, shift, n, s); break;
    }
  } else {
    err = allow_shared(bucketize_scatter_any_kernel, smem);
    if (err == cudaSuccess) {
      const int64_t per_block = threads / 32;
      bucketize_scatter_any_kernel<<<static_cast<unsigned>((num_tiles + per_block - 1) /
                                                           per_block),
                                     threads, smem, s>>>(b, o, pl, pass, num_tiles, tile, shift,
                                                         radix, bits, n);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
