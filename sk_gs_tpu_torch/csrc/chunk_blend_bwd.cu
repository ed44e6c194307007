// Backward blend on the chunk schedule for Hopper (sm_90a), plain C
// interface loaded with ctypes.
//
// Replaces sk_gs_tpu/render/tile_kernel.py:_bwd_kernel, the Pallas kernel
// that repeats the chunk schedule's walk chunk by chunk, carrying each
// tile's transmittance and accumulated colour across its chunks (in order,
// as TPU grid steps run), and writes one gradient row per entry of each
// chunk. Its plain PyTorch version is
// sk_gs_tpu_torch/render/blend.py:chunk_blend_backward_plain. The walk
// follows the forward kernel's rules exactly (chunk_blend_fwd.cu: skip
// power > 0, keep alpha >= 1/255, stop for good at T (1 - alpha) < 1e-4),
// so the backward differentiates what was rendered. The math is the tile
// backward's (tile_blend_bwd.cu): with D = sum_k gout_k C_final_k and
// B_i = sum_k col_ik gout_k, an entry that adds gets
//   g_alpha_i = g_alpha_out T_final / (1 - a_i) + B_i T_excl,i
//               - (D - sum_{j <= i} w_j B_j) / (1 - a_i),
// g_power = alpha_raw g_alpha_i and g_col_i = w_i gout. The Pallas kernel
// carries the colour accumulated so far, c_run [ch, P], and takes the
// suffix as final colour minus an inclusive cumsum; by linearity the sum
// over channels of gout_k times that suffix is D - sum w B, so this kernel
// carries the single running sum s_run = sum w B per pixel instead, in
// float32 (the Pallas cumsum ran as one bf16 MXU pass on the TPU).
//
// What bounds it: FP32 CUDA-core arithmetic on the pair-pixel evaluations
// and the per-entry sums over the tile's pixels, as for the tile backward,
// plus the per-chunk hand-over of T, s_run and the stop flag.
//
// Design: the forward kernel's tickets, wave order and per-tile chain (see
// chunk_blend_fwd.cu; the same argument rules out a deadlock), one block per
// chunk, one thread per pixel. The chunk's entries are staged in shared
// memory; every thread walks them with its own T, stop flag and running sum;
// for each entry, each warp that has an adding pixel sums its lanes' 6 + ch
// terms by shuffles into its own shared-memory slot, and after the walk
// thread j adds the warps' slots for entry j in warp order and writes the
// entry's row. A chunk writes only its own rows, chunk_src + j for
// j < chunk_valid, so no row is written twice and the overlap-tail zeroing
// of the Pallas kernel (tile_kernel.py:474-477) is not needed; the wrapper
// zeroes g_entry, and the rows of a chunk whose tile has stopped stay zero.
// No atomics on the rows; the per-Gaussian sum (index_add_ by sort_gauss)
// stays outside, as for the tile backward.
//
// Rounding: built without fast math and with --fmad=false, using expf, so
// power, alpha and the keep and stop decisions round as in the forward.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// counters as in chunk_blend_fwd.cu: [0] ticket, [1] waits, [2 + t] progress
template <int CH>
__global__ void chunk_blend_bwd_kernel(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, const int* __restrict__ chunk_tile,
    const int* __restrict__ chunk_src, const int* __restrict__ chunk_valid,
    const int* __restrict__ chunk_wave, const int* __restrict__ order,
    const float* __restrict__ tile_color, const float* __restrict__ tile_alpha,
    const float* __restrict__ g_color, const float* __restrict__ g_alpha,
    int* counters, float* t_run, float* s_run_buf, int* done_flag,
    float* __restrict__ g_entry, int chunk_cap, int grid_w, int tile_h,
    int ch_rt) {
  const int ch = CH > 0 ? CH : ch_rt;
  const int nv = 6 + ch;  // values in an entry's gradient row
  const int lp = threadIdx.x;
  const int P = blockDim.x;
  const int lane = lp % kWarp;
  const int warp = lp / kWarp;
  const int n_warps = P / kWarp;
  __shared__ int s_chunk;
  if (lp == 0) s_chunk = order[atomicAdd(&counters[0], 1)];
  __syncthreads();
  const int chunk = s_chunk;
  const int n = chunk_valid[chunk];
  if (n <= 0) return;
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
  float s_run = __ldcg(s_run_buf + pix);  // sum of w_j B_j so far
  bool done = __ldcg(done_flag + pix) != 0;
  if (__syncthreads_count(!done) > 0) {
    extern __shared__ float smem[];
    float* s_x = smem;
    float* s_y = s_x + chunk_cap;
    float* s_a = s_y + chunk_cap;
    float* s_b = s_a + chunk_cap;
    float* s_c = s_b + chunk_cap;
    float* s_o = s_c + chunk_cap;
    float* s_col = s_o + chunk_cap;          // [chunk_cap, ch]
    float* s_part = s_col + chunk_cap * ch;  // [n_warps, chunk_cap, nv]
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
    for (int i = lp; i < n_warps * chunk_cap * nv; i += P) s_part[i] = 0.0f;

    // this pixel's forward outputs and cotangents
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
    const float px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
    const float py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);
    const bool was_done = done;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (!__any_sync(kFull, !done)) break;  // the whole warp has stopped
      const float a = s_a[j], b = s_b[j], c = s_c[j], o = s_o[j];
      const float dx = px - s_x[j];
      const float dy = py - s_y[j];
      const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
      bool adds = false;
      float w = 0.0f, g_power = 0.0f;
      if (!done && power <= 0.0f) {
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
      float* slot = s_part + (static_cast<long long>(warp) * chunk_cap + j) * nv;
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

    for (int j = lp; j < n; j += P) {
      float* out = g_entry + static_cast<long long>(src + j) * nv;
      for (int v = 0; v < nv; ++v) {
        float acc = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi)
          acc += s_part[(static_cast<long long>(wi) * chunk_cap + j) * nv + v];
        out[v] = acc;
      }
    }
    if (!was_done) {
      __stcg(t_run + pix, T);
      __stcg(s_run_buf + pix, s_run);
      __stcg(done_flag + pix, done ? 1 : 0);
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
                   const int* order, const float* tile_color,
                   const float* tile_alpha, const float* g_color,
                   const float* g_alpha, int* counters, float* t_run,
                   float* s_run, int* done_flag, float* g_entry,
                   int num_chunks, int chunk, int grid_w, int tile_h, int ch,
                   cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const int n_warps = threads / kWarp;
  const size_t smem = static_cast<size_t>(chunk) *
                      ((6 + ch) + static_cast<size_t>(n_warps) * (6 + ch)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_blend_bwd_kernel<CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunk_blend_bwd_kernel<CH><<<num_chunks, threads, smem, stream>>>(
      geo, col, sort_gauss, chunk_tile, chunk_src, chunk_valid, chunk_wave,
      order, tile_color, tile_alpha, g_color, g_alpha, counters, t_run, s_run,
      done_flag, g_entry, chunk, grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32 in depth-rank order; sort_gauss int32
// row ids; chunk_tile / chunk_src / chunk_valid / chunk_wave / order
// [num_chunks] int32 as for chunk_blend_fwd; tile_color / g_color
// [T, P, ch] and tile_alpha / g_alpha [T, P] float32; counters
// [2 + num_tiles] int32 zeroed; t_run [T, P] float32 set to 1, s_run
// [T, P] float32 and done_flag [T, P] int32 zeroed; g_entry
// [len(sort_gauss), 6 + ch] float32 zeroed. P = 16 * tile_h, a multiple of
// 32. Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int chunk_blend_bwd(const float* geo, const float* col,
                               const int* sort_gauss, const int* chunk_tile,
                               const int* chunk_src, const int* chunk_valid,
                               const int* chunk_wave, const int* order,
                               const float* tile_color,
                               const float* tile_alpha, const float* g_color,
                               const float* g_alpha, int* counters,
                               float* t_run, float* s_run, int* done_flag,
                               float* g_entry, int num_chunks, int chunk,
                               int grid_w, int tile_h, int ch, void* stream) {
  if (num_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      ch == 3 ? launch<3>(geo, col, sort_gauss, chunk_tile, chunk_src,
                          chunk_valid, chunk_wave, order, tile_color,
                          tile_alpha, g_color, g_alpha, counters, t_run, s_run,
                          done_flag, g_entry, num_chunks, chunk, grid_w, tile_h,
                          ch, s)
              : launch<0>(geo, col, sort_gauss, chunk_tile, chunk_src,
                          chunk_valid, chunk_wave, order, tile_color,
                          tile_alpha, g_color, g_alpha, counters, t_run, s_run,
                          done_flag, g_entry, num_chunks, chunk, grid_w, tile_h,
                          ch, s);
  return static_cast<int>(err);
}

extern "C" const char* chunk_blend_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
