// K3: the global stable scatter of the bucketized runs.
//
// Replaces the Pallas kernel gpuradixsort_tpu/kernels/scatter.py::_window_kernel
// (called by scatter_runs).  After bucketize, tile t holds its digit-r run
// at local_off[t, r] = hist[t, 0] + ... + hist[t, r-1]; the run goes to
//   out[offsets[t, r] + j] = bucketized[t * tile + local_off[t, r] + j]
// for j < hist[t, r].
//
// Bound on the H100: HBM bytes.  Each key and index is read once and written
// once; each tile also reads its hist and offsets rows (2 * radix int32).
//
// Design: one block per tile.  The TPU kernel walks the (digit, tile) runs
// as a sequential grid with a host-made window plan, an SMEM meta table and
// a carried partial row, because the TPU has no random store.  The H100 has
// one, so there is no plan, no window and no carry: the block loads the
// tile's hist and offsets rows into shared memory, thread 0 turns them into
// run ends and per-run deltas (offsets - local_off), and each thread finds
// its slot's run by binary search over the ends and stores it directly.  Neighbouring slots of a run go to
// neighbouring addresses, so stores are coalesced within runs.  Nothing can
// overflow; a destination outside the buffer (possible only for an
// inconsistent hist/offsets pair) is dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_runs_kernel(const uint32_t* __restrict__ keys,
                                    const uint32_t* __restrict__ idx,
                                    const int32_t* __restrict__ hist,
                                    const int32_t* __restrict__ offsets,
                                    uint32_t* __restrict__ out_keys,
                                    uint32_t* __restrict__ out_idx, int tile,
                                    int radix, int64_t n) {
  extern __shared__ int table[];
  int* ends = table;            // inclusive scan of the tile's hist row
  int* delta = table + radix;   // offsets[t, r] - local_off[t, r]
  const int64_t t = blockIdx.x;
  const int64_t base = t * tile;

  // The row loads run in parallel; only the short scan is serial.
  for (int r = threadIdx.x; r < radix; r += blockDim.x) {
    ends[r] = hist[t * radix + r];
    delta[r] = offsets[t * radix + r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int r = 0; r < radix; ++r) {
      delta[r] -= s;
      s += ends[r];
      ends[r] = s;
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    // First run whose end lies past p (searchsorted side="right").
    int lo = 0, hi = radix;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] <= p) lo = mid + 1; else hi = mid;
    }
    const int r = lo < radix - 1 ? lo : radix - 1;
    const int64_t dst = static_cast<int64_t>(delta[r]) + p;
    if (dst >= 0 && dst < n) {
      out_keys[dst] = keys[base + p];
      out_idx[dst] = idx[base + p];
    }
  }
}

}  // namespace

// keys, idx, out_keys, out_idx: num_tiles * tile uint32; hist, offsets:
// (num_tiles, radix) int32.  Returns cudaGetLastError() after the launch.
extern "C" int grs_scatter_runs(const void* keys, const void* idx,
                                const void* hist, const void* offsets,
                                void* out_keys, void* out_idx,
                                int64_t num_tiles, int tile, int radix,
                                void* stream) {
  if (num_tiles > 0) {
    scatter_runs_kernel<<<static_cast<unsigned>(num_tiles), kThreads,
                          2 * radix * sizeof(int),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(idx),
        static_cast<const int32_t*>(hist),
        static_cast<const int32_t*>(offsets), static_cast<uint32_t*>(out_keys),
        static_cast<uint32_t*>(out_idx), tile, radix, num_tiles * tile);
  }
  return static_cast<int>(cudaGetLastError());
}
