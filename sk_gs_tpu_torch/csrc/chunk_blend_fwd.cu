// Forward blend on the chunk schedule for Hopper (sm_90a), plain C interface
// loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_fwd_kernel, the Pallas kernel
// that runs one grid step per padded chunk of the binning's chunk layout
// (chunk_tile / chunk_src / chunk_valid) and carries each tile's
// transmittance and colour from one of its chunks to the next, which the
// TPU allows because its grid steps run in order. Its plain PyTorch version
// is sk_gs_tpu_torch/render/blend.py:chunk_blend_forward_plain. The rules
// are the chunk schedule's: skip power > 0, alpha = min(0.99, o exp(power))
// kept when >= 1/255, a pixel stops for good at the first entry with
// T (1 - alpha) < 1e-4 and does not add it, alpha out = 1 - T.
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations,
// as for the tile kernel (tile_blend_fwd.cu), plus four ints of metadata a
// chunk; past that, the longest tile's chain of chunks, walked by one block.
//
// Design: the TPU grid runs the chunks in order and carries a tile's state
// from one to the next; here a loop inside one block does, as in the chunk
// backward (chunk_blend_bwd.cu). One block per tile, one thread per pixel:
// - the block finds its tile's first chunk in chunk_tile (non-decreasing)
//   by the block-wide search of blend_common.cuh and checks
//   chunk_start_flag there; a tile with no flagged chunk that has entries
//   (an empty tile) writes zero colour and zero alpha;
// - it then walks chunk after chunk, entries chunk_src .. chunk_src +
//   chunk_valid of each, while the next chunk is of the same tile, is not
//   flagged and has entries, through the forward body it shares with the
//   tile kernel (blend_fwd_rows.cuh) with the chunk schedule's skip rule,
//   T, the stop flag and the colour in registers throughout, and leaves
//   once every pixel has stopped.
// Blocks share no state and use no atomics, so two launches on the same
// inputs write the same bits.

#include <cuda_runtime.h>

#include "blend_common.cuh"
#include "blend_fwd_rows.cuh"

namespace {

using namespace blend_fwd;

template <int CH>
__global__ void chunk_blend_fwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ chunk_tile,
    const int* __restrict__ chunk_start_flag,
    const int* __restrict__ chunk_src, const int* __restrict__ chunk_valid,
    float* __restrict__ out_color, float* __restrict__ out_alpha, int nc,
    int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int tile = blockIdx.x;
  Pixel<CH> p = start_pixel<CH>(tile, grid_w, tile_h, ch, out_color);
  const int first = first_chunk_of(chunk_tile, nc, tile);
  if (tile_has_chunks(chunk_tile, chunk_start_flag, chunk_valid, nc, tile,
                      first)) {
    const Shared s = carve_shared(blockDim.x, ch);
    for (int c = first; c < nc; ++c) {
      if (c > first &&
          !chunk_continues(chunk_tile, chunk_start_flag, chunk_valid, c, tile))
        break;
      if (!walk_entries<CH, true>(geo, col, sort_gauss, ch, s, p,
                                  chunk_src[c], chunk_valid[c]))
        break;
    }
  }
  finish_pixel(p, tile, out_alpha);
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* chunk_tile, const int* chunk_start_flag,
                   const int* chunk_src, const int* chunk_valid,
                   float* out_color, float* out_alpha, int num_tiles,
                   int num_chunks, int grid_w, int tile_h, int ch,
                   cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err = allow_shared(chunk_blend_fwd_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  chunk_blend_fwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, chunk_tile, chunk_start_flag, chunk_src,
      chunk_valid, out_color, out_alpha, num_chunks, grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; chunk_tile (non-decreasing) / chunk_start_flag / chunk_src /
// chunk_valid [num_chunks] int32, the binning's chunk layout; out_color
// [num_tiles, P, ch] and out_alpha [num_tiles, P] float32, every value
// written by the kernel. P = 16 * tile_h, a multiple of 32. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int chunk_blend_fwd(const float* geo, const float* col,
                               const int* sort_gauss, const int* chunk_tile,
                               const int* chunk_start_flag,
                               const int* chunk_src, const int* chunk_valid,
                               float* out_color, float* out_alpha,
                               int num_tiles, int num_chunks, int grid_w,
                               int tile_h, int ch, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, chunk_tile, chunk_start_flag,
                          chunk_src, chunk_valid, out_color, out_alpha,
                          num_tiles, num_chunks, grid_w, tile_h, ch, s)
              : launch<0>(geo, col, sort_gauss, chunk_tile, chunk_start_flag,
                          chunk_src, chunk_valid, out_color, out_alpha,
                          num_tiles, num_chunks, grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

// Blocks of chunk_blend_fwd's kernel resident on one SM at this tile height
// and channel count, into *blocks; returns the CUDA error (0 = ok).
extern "C" int chunk_blend_fwd_occupancy(int tile_h, int ch, int* blocks) {
  const int threads = kTile * tile_h;
  const size_t smem = shared_bytes(threads, ch);
  cudaError_t err =
      ch == 3 ? blocks_per_sm(chunk_blend_fwd_kernel<3>, threads, smem, blocks)
              : blocks_per_sm(chunk_blend_fwd_kernel<0>, threads, smem, blocks);
  return static_cast<int>(err);
}

extern "C" const char* chunk_blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
