// Backward tile blend for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_bwd_kernel_tile together with
// the segment sum that follows it in _blend_bwd (:957-982): the Pallas
// kernel repeats each tile's front-to-back walk and writes one gradient row
// per (tile, entry) pair, and _blend_bwd sums those rows onto the Gaussians.
// This kernel computes the whole function, g_rows [R, 6 + ch] per
// depth-ordered row; its plain PyTorch version is
// sk_gs_tpu_torch/render/blend.py:blend_backward_rows_plain. The walk, the
// math and the in-kernel reduction are the shared body in blend_bwd_rows.cuh,
// with the tile schedule's skip rule (power > 1e-4).
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations
// (the forward's ~17 operations, ~49 more for an entry that adds, the sums
// over the tile's pixels included), not bytes: the function reads the rows,
// the live entries' ids and the tiles' pixel tensors once and writes
// g_rows, ~15 MB at full width. Past that, the time is set by the longest
// tile's list, walked by one block.
//
// Design: one block per tile, one thread per pixel (see the shared body).
// What it does about the card:
// - the per-Gaussian sum is the kernel's own global atomics, one a value
//   for each entry some pixel added to; there is no [E, 6 + ch] buffer and no
//   index_add_ over the padding entries, which all landed on the dummy row;
// - shared memory is ~21 KB a block at 256 pixels (batches of 64 entries,
//   per-warp slots marked by a bit mask instead of cleared each batch), so
//   registers, not shared memory, set the blocks resident on an SM
//   (tile_blend_bwd_occupancy reports them);
// - an empty tile exits before its first barrier.

#include <cuda_runtime.h>

#include "blend_bwd_rows.cuh"

namespace {

using namespace blend_bwd;

template <int CH>
__global__ void tile_blend_bwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ tile_color,
    const float* __restrict__ tile_alpha, const float* __restrict__ g_color,
    const float* __restrict__ g_alpha, float* __restrict__ g_rows,
    int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int tile = blockIdx.x;
  const int count = tile_count[tile];
  if (count <= 0) return;
  Pixel<CH> p = load_pixel<CH>(tile, grid_w, tile_h, ch, tile_color,
                               tile_alpha, g_color, g_alpha);
  const Shared s = carve_shared(ch, blockDim.x / kWarp);
  walk_entries<CH, false>(geo, col, sort_gauss, g_rows, ch, s, p,
                          tile_start[tile], count);
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* tile_start, const int* tile_count,
                   const float* tile_color, const float* tile_alpha,
                   const float* g_color, const float* g_alpha, float* g_rows,
                   int num_tiles, int grid_w, int tile_h, int ch,
                   cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err = allow_shared(tile_blend_bwd_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  tile_blend_bwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, tile_start, tile_count, tile_color, tile_alpha,
      g_color, g_alpha, g_rows, grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; tile_start / tile_count [num_tiles] int32; tile_color / g_color
// [num_tiles, 16 * tile_h, ch] and tile_alpha / g_alpha
// [num_tiles, 16 * tile_h] float32; g_rows [R, 6 + ch] float32, zeroed by
// the caller, receives the gradient of geo and col. 16 * tile_h must be a
// multiple of 32. Launches on `stream` and returns cudaGetLastError()
// (0 = ok).
extern "C" int tile_blend_bwd(const float* geo, const float* col,
                              const int* sort_gauss, const int* tile_start,
                              const int* tile_count, const float* tile_color,
                              const float* tile_alpha, const float* g_color,
                              const float* g_alpha, float* g_rows,
                              int num_tiles, int grid_w, int tile_h, int ch,
                              void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, tile_start, tile_count,
                          tile_color, tile_alpha, g_color, g_alpha, g_rows,
                          num_tiles, grid_w, tile_h, ch, s)
              : launch<0>(geo, col, sort_gauss, tile_start, tile_count,
                          tile_color, tile_alpha, g_color, g_alpha, g_rows,
                          num_tiles, grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

// Blocks of tile_blend_bwd's kernel resident on one SM at this tile height
// and channel count, into *blocks; returns the CUDA error (0 = ok).
extern "C" int tile_blend_bwd_occupancy(int tile_h, int ch, int* blocks) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err =
      ch == 3 ? blocks_per_sm(tile_blend_bwd_kernel<3>, threads, smem, blocks)
              : blocks_per_sm(tile_blend_bwd_kernel<0>, threads, smem, blocks);
  return static_cast<int>(err);
}

extern "C" const char* tile_blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
