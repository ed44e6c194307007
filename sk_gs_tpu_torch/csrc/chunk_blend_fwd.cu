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
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations
// (~17 operations and one expf each), as for the tile kernel, plus the
// per-chunk hand-over of a tile's state through device memory (P floats of
// transmittance, P flags and P * ch colours read and written per chunk).
//
// Design: one block per chunk, one thread per pixel of the chunk's tile.
// CUDA blocks run in no order, so the carry is made explicit:
// - a block takes a work ticket from a global atomic counter, not from
//   blockIdx, and works on chunk order[ticket]. The wrapper builds `order`
//   on the device in wave order: every tile's first chunk, then every
//   tile's second chunk, and so on, so a chunk's predecessor in its tile
//   was handed out about one tile count of tickets earlier and has
//   usually finished;
// - each tile's running state (T, stop flag, colour) lives in device
//   memory ([T, P], [T, P], [T, P, ch]); a tile's non-first chunk waits
//   until the tile's progress counter says its predecessors have
//   published (thread 0 spins on it, then a fence), and publishes its own
//   state with a fence and an atomic store when it is done;
// - no deadlock: a chunk waits only on chunks of the same tile in earlier
//   waves, which took earlier tickets, so they have already started (they
//   are resident) and wait only on still earlier tickets themselves;
// - chunks with no valid entry (the trailing padding) exit at once; a block
//   whose tile has stopped at every pixel skips the maths and only
//   publishes (the gate at tile_kernel.py:369);
// - the entries of a chunk are contiguous in sort order; the block stages
//   them (read through sort_gauss from the depth-ordered rows) into shared
//   memory, one per thread, and every thread walks them in order.
// The state is read and written with __ldcg / __stcg (L2, not the SM's L1),
// since another SM may have written it last. Waits are counted.
//
// Rounding: built without fast math and with --fmad=false, using expf, as
// the tile kernel (see tile_blend_fwd.cu).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// counters: [0] the ticket, [1] the number of chunks that had to wait,
// [2 + t] the chunks of tile t published so far
template <int CH>
__global__ void chunk_blend_fwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ chunk_tile,
    const int* __restrict__ chunk_src, const int* __restrict__ chunk_valid,
    const int* __restrict__ chunk_wave, const int* __restrict__ order,
    int* counters, float* t_run, int* done_flag, float* out_color,
    float* out_alpha, int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int lp = threadIdx.x;
  const int P = blockDim.x;
  __shared__ int s_chunk;
  if (lp == 0) s_chunk = order[atomicAdd(&counters[0], 1)];
  __syncthreads();
  const int chunk = s_chunk;
  const int n = chunk_valid[chunk];
  if (n <= 0) return;  // padding past the last list: no state, no successor
  const int tile = chunk_tile[chunk];
  const int wave = chunk_wave[chunk];
  const int src = chunk_src[chunk];
  int* progress = counters + 2 + tile;

  if (lp == 0) {
    volatile int* pr = progress;
    if (*pr < wave) {
      atomicAdd(&counters[1], 1);
      while (*pr < wave) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();

  const long long pix = static_cast<long long>(tile) * P + lp;
  float T = __ldcg(t_run + pix);
  bool done = __ldcg(done_flag + pix) != 0;
  if (__syncthreads_count(!done) > 0) {
    extern __shared__ float smem[];
    float* s_x = smem;
    float* s_y = s_x + n;
    float* s_a = s_y + n;
    float* s_b = s_a + n;
    float* s_c = s_b + n;
    float* s_o = s_c + n;
    float* s_col = s_o + n;  // [n, ch]
    for (int j = lp; j < n; j += P) {
      const int row = sort_gauss[src + j];
      const float* g = geo + static_cast<long long>(row) * 6;
      s_x[j] = g[0];
      s_y[j] = g[1];
      s_a[j] = g[2];
      s_b[j] = g[3];
      s_c[j] = g[4];
      s_o[j] = g[5];
      const float* c = col + static_cast<long long>(row) * ch;
      for (int k = 0; k < ch; ++k) s_col[j * ch + k] = c[k];
    }
    __syncthreads();

    if (!done) {
      const float px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
      const float py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);
      float* my_color = out_color + pix * ch;
      float acc[CH > 0 ? CH : 1];
      if (CH > 0) {
#pragma unroll
        for (int k = 0; k < (CH > 0 ? CH : 1); ++k) acc[k] = __ldcg(my_color + k);
      }
      for (int j = 0; j < n; ++j) {
        const float dx = px - s_x[j];
        const float dy = py - s_y[j];
        const float power =
            -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, s_o[j] * expf(fminf(power, 0.0f)));
        if (alpha < kAlphaMin) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        if (CH > 0) {
#pragma unroll
          for (int k = 0; k < (CH > 0 ? CH : 1); ++k) acc[k] += w * s_col[j * ch + k];
        } else {
          for (int k = 0; k < ch; ++k)
            __stcg(my_color + k, __ldcg(my_color + k) + w * s_col[j * ch + k]);
        }
        T = test_T;
      }
      if (CH > 0) {
#pragma unroll
        for (int k = 0; k < (CH > 0 ? CH : 1); ++k) __stcg(my_color + k, acc[k]);
      }
      __stcg(t_run + pix, T);
      __stcg(done_flag + pix, done ? 1 : 0);
      __stcg(out_alpha + pix, 1.0f - T);
    }
  }

  // publish: every thread's stores before the tile's progress count
  __threadfence();
  __syncthreads();
  if (lp == 0) atomicExch(progress, wave + 1);
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* chunk_tile, const int* chunk_src,
                   const int* chunk_valid, const int* chunk_wave,
                   const int* order, int* counters, float* t_run,
                   int* done_flag, float* out_color, float* out_alpha,
                   int num_chunks, int chunk, int grid_w, int tile_h, int ch,
                   cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = static_cast<size_t>(chunk) * (6 + ch) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_blend_fwd_kernel<CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunk_blend_fwd_kernel<CH><<<num_chunks, threads, smem, stream>>>(
      geo, col, sort_gauss, chunk_tile, chunk_src, chunk_valid, chunk_wave,
      order, counters, t_run, done_flag, out_color, out_alpha, grid_w, tile_h,
      ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; chunk_tile / chunk_src / chunk_valid / chunk_wave / order
// [num_chunks] int32 (order: a permutation of the chunks, a tile's chunks in
// increasing wave); counters [2 + num_tiles] int32 zeroed; t_run [T, P]
// float32 set to 1, done_flag [T, P] int32 zeroed, out_color [T, P, ch] and
// out_alpha [T, P] float32 zeroed, P = 16 * tile_h. Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
extern "C" int chunk_blend_fwd(const float* geo, const float* col,
                               const int* sort_gauss, const int* chunk_tile,
                               const int* chunk_src, const int* chunk_valid,
                               const int* chunk_wave, const int* order,
                               int* counters, float* t_run, int* done_flag,
                               float* out_color, float* out_alpha,
                               int num_chunks, int chunk, int grid_w,
                               int tile_h, int ch, void* stream) {
  if (num_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, chunk_tile, chunk_src,
                          chunk_valid, chunk_wave, order, counters, t_run,
                          done_flag, out_color, out_alpha, num_chunks, chunk,
                          grid_w, tile_h, ch, s)
              : launch<0>(geo, col, sort_gauss, chunk_tile, chunk_src,
                          chunk_valid, chunk_wave, order, counters, t_run,
                          done_flag, out_color, out_alpha, num_chunks, chunk,
                          grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

extern "C" const char* chunk_blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
