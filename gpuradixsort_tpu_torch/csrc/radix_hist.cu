// K1: per-tile digit histograms.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/radix.py::_hist_kernel
// (called by tile_histograms).  hist[t, r] = number of keys in tile t (a
// contiguous stretch of `tile` keys) with (key >> shift) & (radix - 1) == r.
//
// Bound on the H100: HBM bytes.  Each key is read once (4 bytes) and each
// tile writes radix int32 counts; the arithmetic is a shift, a mask and one
// counter update per key.
//
// Design: one block per tile, radix counters in shared memory.  The TPU
// kernel one-hot expands the digits and reduces them with a selector matmul
// because Mosaic has no scatter; here a warp groups its lanes by digit with
// one ballot per digit bit, and one lane per group adds the group's size, so
// a warp issues at most one shared atomic per distinct digit instead of 32.  Loads
// are coalesced: consecutive threads read consecutive keys.  Integer counts
// make the result deterministic.  Any radix up to 256 is taken.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

// A tile is a multiple of 128 keys, so every lane of every warp runs every
// iteration of the key loop and the full-warp mask is always right.
constexpr int kThreads = 128;

__global__ void radix_hist_kernel(const uint32_t* __restrict__ keys,
                                  int32_t* __restrict__ hist, int tile,
                                  int shift, int radix, int bits) {
  extern __shared__ int counts[];
  const int64_t t = blockIdx.x;
  const int64_t base = t * tile;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);

  for (int r = threadIdx.x; r < radix; r += blockDim.x) counts[r] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const uint32_t d = (keys[base + i] >> shift) & mask;
    const unsigned peers = grs::lanes_with_digit(d, bits);
    if (lane == __ffs(peers) - 1) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  for (int r = threadIdx.x; r < radix; r += blockDim.x)
    hist[t * radix + r] = counts[r];
}

}  // namespace

// keys: num_tiles * tile uint32; hist: (num_tiles, radix) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int grs_radix_hist(const void* keys, void* hist, int64_t num_tiles,
                              int tile, int shift, int radix, void* stream) {
  if (num_tiles > 0) {
    radix_hist_kernel<<<static_cast<unsigned>(num_tiles), kThreads,
                        radix * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(hist), tile,
        shift, radix, __builtin_ctz(static_cast<unsigned>(radix)));
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by any entry point of this library.
extern "C" const char* grs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
