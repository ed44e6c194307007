// Backward blend on the chunk schedule for Hopper (sm_90a), plain C
// interface loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_bwd_kernel together with the
// segment sum that follows it in _blend_bwd (:957-982): the Pallas kernel
// repeats the chunk schedule's walk chunk by chunk, carrying each tile's
// transmittance and accumulated colour across its chunks (in order, as TPU
// grid steps run), and writes one gradient row per entry of each chunk;
// _blend_bwd sums those rows onto the Gaussians. This kernel computes the
// whole function, g_rows [R, 6 + ch] per depth-ordered row; its plain
// PyTorch version is
// sk_gs_tpu_torch/render/blend.py:chunk_blend_backward_rows_plain. The
// walk, the math and the in-kernel reduction are the shared body in
// blend_bwd_rows.cuh, with the chunk schedule's skip rule (power > 0). The
// Pallas kernel carries the colour accumulated so far, c_run [ch, P], and
// takes the suffix as final colour minus an inclusive cumsum; by linearity
// the sum over channels of gout_k times that suffix is D - sum w B, so the
// body carries the single running sum s_run = sum w B per pixel instead, in
// float32 (the Pallas cumsum ran as one bf16 MXU pass on the TPU).
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations
// and the sums over the tile's pixels, as for the tile backward
// (tile_blend_bwd.cu); past that, the longest tile's chain of chunks,
// walked by one block.
//
// Design: the TPU grid runs the chunks in order and carries a tile's state
// from one to the next; here a loop inside one block does. One block per
// tile, one thread per pixel:
// - the block finds its tile's first chunk in chunk_tile, which the binning
//   builds non-decreasing (a running max), by a search in which every
//   thread probes one point a round (two rounds at 8,817 chunks;
//   blend_common.cuh, shared with the chunk forward), and checks
//   chunk_start_flag there; a tile with no flagged chunk that has entries
//   (an empty tile) exits at once;
// - it then walks chunk after chunk, entries chunk_src .. chunk_src +
//   chunk_valid of each, while the next chunk is of the same tile, is not
//   flagged and has entries, with T, s_run and the stop flag in registers
//   throughout. No tickets, progress counters, waits or state in device
//   memory, so the wrapper needs no wave-order sort and no scratch;
// - the pixels stop for good, as in the forward (chunk_blend_fwd.cu), and
//   the block leaves its tile once all of them have.

#include <cuda_runtime.h>

#include "blend_bwd_rows.cuh"
#include "blend_common.cuh"

namespace {

using namespace blend_bwd;

template <int CH>
__global__ void chunk_blend_bwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ chunk_tile,
    const int* __restrict__ chunk_start_flag,
    const int* __restrict__ chunk_src, const int* __restrict__ chunk_valid,
    const float* __restrict__ tile_color, const float* __restrict__ tile_alpha,
    const float* __restrict__ g_color, const float* __restrict__ g_alpha,
    float* __restrict__ g_rows, int nc, int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int tile = blockIdx.x;
  const int first = first_chunk_of(chunk_tile, nc, tile);
  if (!tile_has_chunks(chunk_tile, chunk_start_flag, chunk_valid, nc, tile,
                       first))
    return;  // an empty tile: no chunk of its own
  Pixel<CH> p = load_pixel<CH>(tile, grid_w, tile_h, ch, tile_color,
                               tile_alpha, g_color, g_alpha);
  const Shared s = carve_shared(ch, blockDim.x / kWarp);
  for (int c = first; c < nc; ++c) {
    if (c > first &&
        !chunk_continues(chunk_tile, chunk_start_flag, chunk_valid, c, tile))
      break;
    if (!walk_entries<CH, true>(geo, col, sort_gauss, g_rows, ch, s, p,
                                chunk_src[c], chunk_valid[c]))
      break;
  }
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* chunk_tile, const int* chunk_start_flag,
                   const int* chunk_src, const int* chunk_valid,
                   const float* tile_color, const float* tile_alpha,
                   const float* g_color, const float* g_alpha, float* g_rows,
                   int num_tiles, int num_chunks, int grid_w, int tile_h,
                   int ch, cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err = allow_shared(chunk_blend_bwd_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  chunk_blend_bwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, chunk_tile, chunk_start_flag, chunk_src,
      chunk_valid, tile_color, tile_alpha, g_color, g_alpha, g_rows,
      num_chunks, grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; chunk_tile (non-decreasing) / chunk_start_flag / chunk_src /
// chunk_valid [num_chunks] int32, the binning's chunk layout; tile_color /
// g_color [num_tiles, P, ch] and tile_alpha / g_alpha [num_tiles, P]
// float32; g_rows [R, 6 + ch] float32, zeroed by the caller, receives the
// gradient of geo and col. P = 16 * tile_h, a multiple of 32. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int chunk_blend_bwd(const float* geo, const float* col,
                               const int* sort_gauss, const int* chunk_tile,
                               const int* chunk_start_flag,
                               const int* chunk_src, const int* chunk_valid,
                               const float* tile_color,
                               const float* tile_alpha, const float* g_color,
                               const float* g_alpha, float* g_rows,
                               int num_tiles, int num_chunks, int grid_w,
                               int tile_h, int ch, void* stream) {
  if (num_tiles == 0 || num_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, chunk_tile, chunk_start_flag,
                          chunk_src, chunk_valid, tile_color, tile_alpha,
                          g_color, g_alpha, g_rows, num_tiles, num_chunks,
                          grid_w, tile_h, ch, s)
              : launch<0>(geo, col, sort_gauss, chunk_tile, chunk_start_flag,
                          chunk_src, chunk_valid, tile_color, tile_alpha,
                          g_color, g_alpha, g_rows, num_tiles, num_chunks,
                          grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

// Blocks of chunk_blend_bwd's kernel resident on one SM at this tile height
// and channel count, into *blocks; returns the CUDA error (0 = ok).
extern "C" int chunk_blend_bwd_occupancy(int tile_h, int ch, int* blocks) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err =
      ch == 3 ? blocks_per_sm(chunk_blend_bwd_kernel<3>, threads, smem, blocks)
              : blocks_per_sm(chunk_blend_bwd_kernel<0>, threads, smem, blocks);
  return static_cast<int>(err);
}

extern "C" const char* chunk_blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
