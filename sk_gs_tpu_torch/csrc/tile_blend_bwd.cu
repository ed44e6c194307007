// Backward tile blend for Hopper (sm_90a), plain C interface loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_bwd_kernel_tile, the Pallas
// kernel that repeats each tile's front-to-back walk and writes one gradient
// row per (tile, entry) pair. Its plain PyTorch version is
// sk_gs_tpu_torch/render/blend.py:blend_backward_plain. The walk follows the
// forward kernel's rules exactly (skip power > 1e-4, keep alpha >= 1/255,
// a pixel stops for good at the first kept entry with T (1 - alpha) < 1e-4,
// see tile_blend_fwd.cu), so the backward differentiates what was rendered.
// The math is the Pallas kernel's (tile_kernel.py:606-697): with
// D = sum_k gout_k C_final_k and B_i = sum_k col_ik gout_k, an entry that
// adds gets
//   g_alpha_i = g_alpha_out T_final / (1 - a_i) + B_i T_excl,i
//               - (D - sum_{j <= i} w_j B_j) / (1 - a_i),
//   g_power = alpha_raw g_alpha_i (the 0.99 clamp counts as identity),
//   g_col_i = w_i gout,
// and the conic / position / opacity terms follow from the quadratic form.
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations
// (the forward's ~17 operations, ~20 more for an entry that adds) and the
// per-entry sums over the tile's pixels, not bytes: an entry costs ~40 bytes
// in and 4 (6 + ch) bytes out, and is evaluated at up to P = 256 pixels.
//
// Design, right and simple first: one block per tile, one thread per pixel.
// Entries are staged in shared memory in batches of one per thread, as in the
// forward. Every thread walks the batch with its own T, stop flag and running
// sum of w B. For each entry, each warp that has an adding pixel sums its
// lanes' 6 + ch terms by shuffles and stores them in its own shared-memory
// slot; after the batch, thread j adds the warps' slots for entry j in warp
// order and writes the entry's row. So the result needs no atomics and does
// not depend on scheduling. An entry belongs to one tile, so its row of
// g_entry [E, 6 + ch] is written by one block; the wrapper zeroes g_entry,
// and rows past a tile's stop stay zero. The per-Gaussian sum (index_add_
// by sort_gauss) stays outside, as the JAX package's segment_sum does.
//
// Rounding: built without fast math and with --fmad=false, using expf, so
// power, alpha and the keep and stop decisions round as in the forward
// kernel and the plain version. T, the running sum and the pixel sums are
// taken in another order than the plain version's cumprod, cumsum and sums.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kPowerSkipEps = 1e-4f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// CH > 0: compile-time channel count, g_color row in registers.
// CH == 0: runtime ch, g_color read from its row in device memory.
template <int CH>
__global__ void tile_blend_bwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ tile_color,
    const float* __restrict__ tile_alpha, const float* __restrict__ g_color,
    const float* __restrict__ g_alpha, float* __restrict__ g_entry,
    int grid_w, int tile_h, int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int nv = 6 + ch;  // values in an entry's gradient row
  const int tile = blockIdx.x;
  const int lp = threadIdx.x;
  const int batch = blockDim.x;
  const int lane = lp % kWarp;
  const int warp = lp / kWarp;
  const int n_warps = batch / kWarp;
  const float px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
  const float py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);

  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + batch;
  float* s_a = s_y + batch;
  float* s_b = s_a + batch;
  float* s_c = s_b + batch;
  float* s_o = s_c + batch;
  float* s_col = s_o + batch;          // [batch, ch]
  float* s_part = s_col + batch * ch;  // [n_warps, batch, nv]

  // this pixel's forward outputs and cotangents
  const long long pix = static_cast<long long>(tile) * batch + lp;
  const float* gout_row = g_color + pix * ch;
  float gout[CH > 0 ? CH : 1];
  float d_tot = 0.0f;  // D = sum_k gout_k C_final_k
  for (int k = 0; k < ch; ++k) {
    const float gk = gout_row[k];
    if (CH > 0) gout[k] = gk;
    d_tot += gk * tile_color[pix * ch + k];
  }
  const float t_final = 1.0f - tile_alpha[pix];
  const float ga_out = g_alpha[pix];

  const int begin = tile_start[tile];
  const int count = tile_count[tile];
  float T = 1.0f;
  float s_run = 0.0f;  // sum of w_j B_j over the entries that added
  bool done = false;

  for (int base = 0; base < count; base += batch) {
    // barrier: also keeps the previous batch's slots alive until every
    // thread has written its row
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(batch, count - base);
    if (lp < n) {
      const int row = sort_gauss[begin + base + lp];
      const float* g = geo + static_cast<long long>(row) * 6;
      s_x[lp] = g[0];
      s_y[lp] = g[1];
      s_a[lp] = g[2];
      s_b[lp] = g[3];
      s_c[lp] = g[4];
      s_o[lp] = g[5];
      const float* c = col + static_cast<long long>(row) * ch;
      for (int k = 0; k < ch; ++k) s_col[lp * ch + k] = c[k];
    }
    for (int i = lp; i < n_warps * batch * nv; i += batch) s_part[i] = 0.0f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (!__any_sync(kFull, !done)) break;  // the whole warp has stopped
      const float a = s_a[j], b = s_b[j], c = s_c[j], o = s_o[j];
      const float dx = px - s_x[j];
      const float dy = py - s_y[j];
      const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
      bool adds = false;
      float w = 0.0f, g_power = 0.0f;
      if (!done && power <= kPowerSkipEps) {
        const float alpha_raw = o * expf(fminf(power, 0.0f));
        const float alpha = fminf(kAlphaMax, alpha_raw);
        if (alpha >= kAlphaMin) {
          const float om = 1.0f - alpha;
          const float test_T = T * om;
          if (test_T < kTEps) {
            done = true;
          } else {
            w = alpha * T;
            float bsum = 0.0f;  // B = sum_k col_k gout_k
            for (int k = 0; k < ch; ++k)
              bsum += s_col[j * ch + k] * (CH > 0 ? gout[k] : gout_row[k]);
            s_run += w * bsum;
            const float inv_om = 1.0f / om;
            const float g_alpha_i = ga_out * t_final * inv_om + bsum * T -
                                    (d_tot - s_run) * inv_om;
            g_power = alpha_raw * g_alpha_i;
            T = test_T;
            adds = true;
          }
        }
      }
      if (!__any_sync(kFull, adds)) continue;  // the slot stays zero
      const float inv_o = o > 0.0f ? 1.0f / fmaxf(o, 1e-12f) : 0.0f;
      float vals[6];
      vals[0] = (a * dx + b * dy) * g_power;
      vals[1] = (c * dy + b * dx) * g_power;
      vals[2] = -0.5f * dx * dx * g_power;
      vals[3] = -dx * dy * g_power;
      vals[4] = -0.5f * dy * dy * g_power;
      vals[5] = g_power * inv_o;
      float* slot = s_part + (static_cast<long long>(warp) * batch + j) * nv;
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        const float s = warp_sum(adds ? vals[v] : 0.0f);
        if (lane == 0) slot[v] = s;
      }
      for (int k = 0; k < ch; ++k) {
        const float s = warp_sum(w * (CH > 0 ? gout[k] : gout_row[k]));
        if (lane == 0) slot[6 + k] = s;
      }
    }
    __syncthreads();

    if (lp < n) {
      float* out = g_entry + static_cast<long long>(begin + base + lp) * nv;
      for (int v = 0; v < nv; ++v) {
        float acc = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi)
          acc += s_part[(static_cast<long long>(wi) * batch + lp) * nv + v];
        out[v] = acc;
      }
    }
  }
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* tile_start, const int* tile_count,
                   const float* tile_color, const float* tile_alpha,
                   const float* g_color, const float* g_alpha, float* g_entry,
                   int num_tiles, int grid_w, int tile_h, int ch,
                   cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const int n_warps = threads / kWarp;
  const size_t smem = static_cast<size_t>(threads) *
                      ((6 + ch) + static_cast<size_t>(n_warps) * (6 + ch)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_blend_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_blend_bwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, tile_start, tile_count, tile_color, tile_alpha,
      g_color, g_alpha, g_entry, grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; tile_start / tile_count [num_tiles] int32; tile_color / g_color
// [num_tiles, 16 * tile_h, ch] and tile_alpha / g_alpha
// [num_tiles, 16 * tile_h] float32; g_entry [len(sort_gauss), 6 + ch]
// float32, zeroed by the caller. 16 * tile_h must be a multiple of 32.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int tile_blend_bwd(const float* geo, const float* col,
                              const int* sort_gauss, const int* tile_start,
                              const int* tile_count, const float* tile_color,
                              const float* tile_alpha, const float* g_color,
                              const float* g_alpha, float* g_entry,
                              int num_tiles, int grid_w, int tile_h, int ch,
                              void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, tile_start, tile_count,
                          tile_color, tile_alpha, g_color, g_alpha, g_entry,
                          num_tiles, grid_w, tile_h, ch, s)
              : launch<0>(geo, col, sort_gauss, tile_start, tile_count,
                          tile_color, tile_alpha, g_color, g_alpha, g_entry,
                          num_tiles, grid_w, tile_h, ch, s);
  return static_cast<int>(err);
}

extern "C" const char* tile_blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
