// K2: stable sort of every tile's (key, index) pairs by the current digit.
//
// Replaces the Pallas kernel
// gpuradixsort_tpu/kernels/bucketize.py::_bucketize_kernel (with
// _bucketize_tile and _row_bitonic_sortkeys; called by bucketize_tiles).
// The output equals a per-tile argsort(digit, stable) applied to key and
// index.
//
// Bound on the H100: HBM bytes, 16 a key: key and index each read once and
// written once.
//
// Design: one warp per tile and no block barrier, so that a tile's keys are
// read from device memory once and many loads are in flight.  The TPU kernel
// runs a 28-stage bitonic network per row because Mosaic has no per-element
// scatter; here every pair goes straight to its slot.  For the default
// 1,024-key tile (bucketize_1k_kernel) a warp:
//   1. copies its next tile's keys and indices into shared memory with
//      cp.async (16-byte copies where the inputs allow) while it ranks the
//      current one: the warps are persistent, one grid-stride loop over the
//      tiles, so a tile's loads overlap the previous tile's work;
//   2. reads the tile warp-striped (lane l's item j is element 32 j + l) into
//      registers: 32 keys and 32 indices a lane;
//   3. ranks the items in element order with one ballot per digit bit: an
//      item's slot within its digit is the count of that digit in earlier
//      items (lane r keeps the running count of digit r; a shuffle reads it)
//      plus its peers in lower lanes.  After the last item lane r holds the
//      tile's count of digit r: the histogram falls out, and one warp scan of
//      it gives the digit starts;
//   4. places each pair at start[digit] + slot in shared staging and writes
//      the staged tile with 16-byte stores.
// Flat order is (item, lane), which is element order, so equal digits keep
// their order.  Every other tile (bucketize_any_kernel) takes a slower route:
// one tile a warp, counting the whole tile from device memory, then reading
// it again to rank and place it.  Steps 3 and 4 are grs::rank_1k and
// grs::rank_any (tile.cuh).  The fused sort's pass (bucketize_scatter.cu)
// does this kernel's work inside its own, so this one runs off the main
// path, beside its plain version and in the bench's stage table.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kMaxRadix = 16;
constexpr int kFastTile = grs::kFastTile;
constexpr int kItems = grs::kFastItems;
constexpr int kMaxWarps = 8;         // tiles a block
constexpr int kMaxShared = 232448;   // shared memory a block may use (H100)

// The staged tile out with 16-byte stores (the outputs are 16-byte aligned).
__device__ __forceinline__ void store_tile(uint32_t* out_keys, uint32_t* out_idx,
                                           const uint32_t* sk, const uint32_t* sv,
                                           int64_t base, int tile, int lane) {
  uint4* ok = reinterpret_cast<uint4*>(out_keys + base);
  uint4* ov = reinterpret_cast<uint4*>(out_idx + base);
  const uint4* sk4 = reinterpret_cast<const uint4*>(sk);
  const uint4* sv4 = reinterpret_cast<const uint4*>(sv);
  for (int i = lane; i < tile / 4; i += 32) {
    ok[i] = sk4[i];
    ov[i] = sv4[i];
  }
}

template <int kBits>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_1k_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                        uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                        int64_t num_tiles, int shift, bool vec) {
  // Per warp: the input tile (keys, then indices), then the staged output.
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // no block barrier follows

  uint32_t* in = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * 4 * kFastTile;
  uint32_t* sk = in + 2 * kFastTile;
  uint32_t* sv = sk + kFastTile;
  grs::load_tile<kFastTile>(in, keys, idx, t, lane, vec);

  for (; t < num_tiles; t += stride) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    uint32_t k[kItems], v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = in[32 * j + lane];
      v[j] = in[kFastTile + 32 * j + lane];
    }
    __syncwarp();  // every lane has read the tile: refill the buffer
    if (t + stride < num_tiles) grs::load_tile<kFastTile>(in, keys, idx, t + stride, lane, vec);
    grs::rank_1k<kBits>(k, v, shift, lane, sk, sv);
    __syncwarp();
    store_tile(out_keys, out_idx, sk, sv, t * kFastTile, kFastTile, lane);
    __syncwarp();  // the staging is rewritten by the next tile
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    bucketize_any_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ idx,
                         uint32_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx,
                         int64_t num_tiles, int tile, int shift, int radix, int bits) {
  extern __shared__ uint4 smem[];  // per warp: the staged output
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= num_tiles) return;  // no block barrier follows

  uint32_t* sk = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * 2 * tile;
  uint32_t* sv = sk + tile;
  const int64_t base = t * tile;
  int start;
  grs::rank_any(keys + base + lane, idx + base + lane, tile >> 5, shift, radix, bits, lane, sk,
                sv, start);
  __syncwarp();
  store_tile(out_keys, out_idx, sk, sv, base, tile, lane);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Persistent launch: as many blocks as fit on the card at once, at most one
// per `per_block` tiles.
template <int kBits>
cudaError_t launch_1k(const uint32_t* keys, const uint32_t* idx, uint32_t* out_keys,
                      uint32_t* out_idx, int64_t num_tiles, int threads, size_t smem, int shift,
                      bool vec, cudaStream_t stream) {
  const auto kernel = bucketize_1k_kernel<kBits>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem)) !=
          cudaSuccess) {
    return err;
  }
  const int64_t per_block = threads / 32;
  int64_t blocks = (num_tiles + per_block - 1) / per_block;
  if (resident > 0 && blocks > static_cast<int64_t>(resident) * sms)
    blocks = static_cast<int64_t>(resident) * sms;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(keys, idx, out_keys, out_idx,
                                                                   num_tiles, shift, vec);
  return cudaSuccess;
}

}  // namespace

// keys, idx, out_keys, out_idx: num_tiles * tile uint32, the outputs 16-byte
// aligned.  One warp per tile: threads is 32 x the tiles of a block, at most
// 32 x 8.  A block keeps 16 x tile bytes a warp in shared memory for the
// 1,024-key tile (input and staged output) and 8 x tile bytes a warp for any
// other (staged output), at most 232,448 bytes.  tile is a multiple of 128;
// radix a power of two <= 16.  Returns cudaGetLastError() after the launch.
extern "C" int grs_bucketize(const void* keys, const void* idx, void* out_keys,
                             void* out_idx, int64_t num_tiles, int tile,
                             int threads, int shift, int radix, void* stream) {
  const bool fast = tile == kFastTile;
  const size_t smem = static_cast<size_t>(threads / 32) * (fast ? 4 : 2) *
                      static_cast<size_t>(tile) * sizeof(uint32_t);
  if (radix < 2 || radix > kMaxRadix || (radix & (radix - 1)) != 0 ||
      threads < 32 || threads % 32 != 0 || threads > 32 * kMaxWarps ||
      tile <= 0 || tile % 128 != 0 || smem > kMaxShared ||
      !aligned16(out_keys) || !aligned16(out_idx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* v = static_cast<const uint32_t*>(idx);
  const bool vec = aligned16(keys) && aligned16(idx);
  auto* ok = static_cast<uint32_t*>(out_keys);
  auto* ov = static_cast<uint32_t*>(out_idx);
  const auto s = static_cast<cudaStream_t>(stream);
  const int bits = __builtin_ctz(static_cast<unsigned>(radix));
  cudaError_t err = cudaSuccess;
  if (fast) {
    switch (bits) {
      case 1: err = launch_1k<1>(k, v, ok, ov, num_tiles, threads, smem, shift, vec, s); break;
      case 2: err = launch_1k<2>(k, v, ok, ov, num_tiles, threads, smem, shift, vec, s); break;
      case 3: err = launch_1k<3>(k, v, ok, ov, num_tiles, threads, smem, shift, vec, s); break;
      default: err = launch_1k<4>(k, v, ok, ov, num_tiles, threads, smem, shift, vec, s); break;
    }
  } else {
    err = allow_shared(bucketize_any_kernel, smem);
    if (err == cudaSuccess) {
      const int64_t per_block = threads / 32;
      bucketize_any_kernel<<<static_cast<unsigned>((num_tiles + per_block - 1) / per_block),
                             threads, smem, s>>>(k, v, ok, ov, num_tiles, tile, shift, radix,
                                                 bits);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
