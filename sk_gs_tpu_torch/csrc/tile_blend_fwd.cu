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
// about 15 flops and one expf each, not bytes: an entry costs ~40 bytes to
// read (a 4-byte id plus 6 + ch floats) and is then evaluated at up to
// P = 256 pixels.
//
// Design, right and simple first: one block per tile, one thread per pixel
// (16 * tile_h threads). The block stages a batch of entries (one per
// thread) into shared memory cooperatively, reading them through
// sort_gauss from the depth-ordered per-Gaussian arrays, so each entry is
// read from device memory once per tile; every thread then walks the batch
// in order with its own transmittance and stop flag. The block leaves the
// loop once __syncthreads_count says no pixel is live. Empty tiles write
// zeros colour and zero alpha.
//
// Rounding: built without fast math and with --fmad=false, and using expf,
// so that power and alpha are rounded op for op as the plain version's
// elementwise tensors are on the card, and the keep decisions agree with it
// exactly. The transmittance products and colour sums are taken in another
// order there (a running product against a cumprod, a sum against a matmul).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kPowerSkipEps = 1e-4f;

// CH > 0: compile-time channel count, accumulators in registers.
// CH == 0: runtime ch, accumulators in the thread's own output row.
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
  const int lp = threadIdx.x;
  const int batch = blockDim.x;
  const int P = kTile * tile_h;
  const float px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
  const float py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);

  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + batch;
  float* s_a = s_y + batch;
  float* s_b = s_a + batch;
  float* s_c = s_b + batch;
  float* s_o = s_c + batch;
  float* s_col = s_o + batch;  // [batch, ch]

  float* my_color = out_color + (static_cast<long long>(tile) * P + lp) * ch;
  float acc[CH > 0 ? CH : 1];
  if (CH > 0) {
#pragma unroll
    for (int k = 0; k < (CH > 0 ? CH : 1); ++k) acc[k] = 0.0f;
  } else {
    for (int k = 0; k < ch; ++k) my_color[k] = 0.0f;
  }

  const int begin = tile_start[tile];
  const int count = tile_count[tile];
  float T = 1.0f;
  bool done = false;

  for (int base = 0; base < count; base += batch) {
    // barrier: also keeps the previous batch alive until every thread is
    // through with it
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
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = px - s_x[j];
      const float dy = py - s_y[j];
      const float power =
          -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
      if (power > kPowerSkipEps) continue;
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
        for (int k = 0; k < ch; ++k) my_color[k] += w * s_col[j * ch + k];
      }
      T = test_T;
    }
  }

  if (CH > 0) {
#pragma unroll
    for (int k = 0; k < (CH > 0 ? CH : 1); ++k) my_color[k] = acc[k];
  }
  out_alpha[static_cast<long long>(tile) * P + lp] = 1.0f - T;
}

template <int CH>
cudaError_t launch(const float* geo, const float* col, const int* sort_gauss,
                   const int* tile_start, const int* tile_count,
                   float* out_color, float* out_alpha, int num_tiles,
                   int grid_w, int tile_h, int ch, cudaStream_t stream) {
  const int threads = kTile * tile_h;
  const size_t smem = static_cast<size_t>(threads) * (6 + ch) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_blend_fwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_blend_fwd_kernel<CH><<<num_tiles, threads, smem, stream>>>(
      geo, col, sort_gauss, tile_start, tile_count, out_color, out_alpha,
      grid_w, tile_h, ch);
  return cudaGetLastError();
}

}  // namespace

// geo [R, 6] and col [R, ch] float32, in depth-rank order; sort_gauss int32
// row ids; tile_start / tile_count [num_tiles] int32; out_color
// [num_tiles, 16 * tile_h, ch] and out_alpha [num_tiles, 16 * tile_h]
// float32. Launches on `stream` and returns cudaGetLastError() (0 = ok).
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

extern "C" const char* tile_blend_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
