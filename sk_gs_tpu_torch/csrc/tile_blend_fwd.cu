// Forward tile blend for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_fwd_kernel_tile, the Pallas
// kernel that blends each 16 x tile_h tile's depth-sorted splat segment
// front to back. Its plain PyTorch version is
// sk_gs_tpu_torch/render/blend.py:blend_forward_plain; the blend rules are
// the same (skip power > 1e-4, alpha = min(0.99, o exp(power)) kept when
// >= 1/255, a pixel stops at the first entry with T (1 - alpha) < 1e-4 and
// does not add it, alpha out = 1 - T).
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations,
// about 17 operations each and one expf where the entry is not skipped
// first, not bytes: an entry costs ~40 bytes to read (a 4-byte id plus
// 6 + ch floats) and is then evaluated at up to P = 256 pixels. Past that,
// the longest lists whose pixels stay open, walked by one block each.
//
// Design: one block per tile, one thread per pixel (16 * tile_h threads),
// through the forward body it shares with the chunk schedule's kernel,
// blend_fwd_rows.cuh: packed float4 staging, an exact pre-test that skips
// most evaluations without expf, and the block's exit once no pixel is
// live. The tile's
// whole list is one range of sort order, [tile_start, tile_start +
// tile_count). Empty tiles write zero colour and zero alpha.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "blend_fwd_rows.cuh"

namespace {

using namespace blend_fwd;

template <int CH>
__global__ void tile_blend_fwd_kernel(const float* __restrict__ geo,
                                      const float* __restrict__ col,
                                      const int* __restrict__ sort_gauss,
                                      const int* __restrict__ tile_start,
                                      const int* __restrict__ tile_count,
                                      float* __restrict__ out_color,
                                      float* __restrict__ out_alpha,
                                      int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int tile = blockIdx.x;
  Pixel<CH> p = start_pixel<CH>(tile, grid_w, tile_h, ch, out_color);
  const Shared s = carve_shared(blockDim.x, ch);
  walk_entries<CH, false>(geo, col, sort_gauss, ch, s, p, tile_start[tile],
                          tile_count[tile]);
  finish_pixel(p, tile, out_alpha);
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* tile_start, const int* tile_count,
                   float* out_color, float* out_alpha, int num_tiles,
                   int grid_w, int tile_h, int ch, cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err = allow_shared(tile_blend_fwd_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  tile_blend_fwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, tile_start, tile_count, out_color, out_alpha,
      grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32, in depth-rank order; sort_gauss int32
// row ids; tile_start / tile_count [num_tiles] int32; out_color
// [num_tiles, P, ch] and out_alpha [num_tiles, P] float32, every value
// written by the kernel. P = 16 * tile_h, a multiple of 32. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int tile_blend_fwd(const float* geo, const float* col,
                              const int* sort_gauss, const int* tile_start,
                              const int* tile_count, float* out_color,
                              float* out_alpha, int num_tiles, int grid_w,
                              int tile_h, int ch, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = ch == 3
      ? launch<3>(geo, col, sort_gauss, tile_start, tile_count, out_color,
                  out_alpha, num_tiles, grid_w, tile_h, ch, s)
      : launch<0>(geo, col, sort_gauss, tile_start, tile_count, out_color,
                  out_alpha, num_tiles, grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

// Blocks of tile_blend_fwd's kernel resident on one SM at this tile height
// and channel count, into *blocks; returns the CUDA error (0 = ok).
extern "C" int tile_blend_fwd_occupancy(int tile_h, int ch, int* blocks) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err =
      ch == 3 ? blocks_per_sm(tile_blend_fwd_kernel<3>, threads, smem, blocks)
              : blocks_per_sm(tile_blend_fwd_kernel<0>, threads, smem, blocks);
  return static_cast<int>(err);
}

extern "C" const char* tile_blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
