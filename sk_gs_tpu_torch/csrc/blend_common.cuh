// What the four blend kernels share: the blend rules' constants, the search
// for a tile's first chunk in the chunk layout (kernels #3 and #4), and the
// shared-memory and occupancy helpers of the launchers.

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kTile = 16;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// The first c in [0, nc) with chunk_tile[c] >= tile (nc if none), for a
// non-decreasing chunk_tile (the binning builds it as a running max). Every
// thread of the block calls it; each round every thread probes one point of
// the remaining range, and the count of probes below `tile` (a prefix,
// chunk_tile being sorted) narrows it: two rounds at 8,817 chunks and 256
// threads.
__device__ __forceinline__ int first_chunk_of(const int* __restrict__ chunk_tile,
                                              int nc, int tile) {
  const int P = blockDim.x;
  int lo = 0, hi = nc;
  while (lo < hi) {
    const int stride = (hi - lo + P - 1) / P;
    const int c = lo + static_cast<int>(threadIdx.x) * stride;
    const int below = __syncthreads_count(c < hi && chunk_tile[c] < tile);
    const int next_lo = below > 0 ? lo + (below - 1) * stride + 1 : lo;
    hi = min(hi, lo + below * stride);
    lo = next_lo;
  }
  return lo;
}

// Whether the chunk layout gives `tile` a list: its first chunk is its own,
// flagged as a tile's first and holds entries. An empty tile has none.
__device__ __forceinline__ bool tile_has_chunks(
    const int* __restrict__ chunk_tile, const int* __restrict__ chunk_start_flag,
    const int* __restrict__ chunk_valid, int nc, int tile, int first) {
  return first < nc && chunk_tile[first] == tile &&
         chunk_start_flag[first] != 0 && chunk_valid[first] > 0;
}

// Whether chunk c > first continues the tile's list that starts at `first`:
// the same tile, not flagged as another list's start, and not empty.
__device__ __forceinline__ bool chunk_continues(
    const int* __restrict__ chunk_tile, const int* __restrict__ chunk_start_flag,
    const int* __restrict__ chunk_valid, int c, int tile) {
  return chunk_tile[c] == tile && chunk_start_flag[c] == 0 && chunk_valid[c] > 0;
}

// Sets the kernel's dynamic shared memory limit where it exceeds the 48 KB
// default.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of `threads` threads that can be resident on one SM at once.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem, int* blocks) {
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // namespace blend
