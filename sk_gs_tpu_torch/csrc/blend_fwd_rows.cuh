// The device body shared by the two forward blend kernels, tile_blend_fwd.cu
// (the tile schedule, kernel #1) and chunk_blend_fwd.cu (the chunk
// schedule, kernel #3): one block per tile, one thread per pixel, walking
// the tile's entries front to back with the pixel's transmittance T, its
// stop flag and its colour in registers from the tile's first entry to its
// last. Kernel #1 hands the body its tile's one range of sort order, kernel
// #3 each of its tile's chunks in turn.
//
// The rules are the plain versions' (sk_gs_tpu_torch/render/blend.py): skip
// power > 1e-4 on the tile schedule and power > 0 on the chunk schedule,
// alpha = min(0.99, o exp(min(power, 0))) kept when >= 1/255, a pixel stops
// for good at the first kept entry with T (1 - alpha) < 1e-4 and does not
// add it; alpha out = 1 - T.
//
// Staging. The block stages one entry per thread at a time into shared
// memory, read through sort_gauss from the depth-ordered rows, each as
// whole float4s: (x, y, a, b), (c, o, cut, 0) and the colour (one float4 at
// ch = 3), so a thread reads an entry with 16-byte loads that every lane of
// the warp shares.
//
// The pre-test. At staging, an entry with o <= 1 gets cut = logf(kAlphaMin
// / o) - kCutMargin (others -inf, no pre-test), and an evaluation with
// power < cut is skipped without expf. That skip is exact: power < cut
// proves fl(o expf(min(power, 0))) < kAlphaMin, so the exact path would
// have dropped it too. With u = 2^-24, x = min(power, 0) and CUDA's
// documented bounds (division correctly rounded, logf within 1 ulp, expf
// within 2), expf(x) <= 1 + 4u, and:
// - o < kAlphaMin (1 - 2^-21): fl(o expf(x)) <= o (1 + 4u)(1 + u) <
//   kAlphaMin at every power, so any skip is exact (o = 0 gives cut = +inf;
//   a negative o a NaN cut, which skips nothing);
// - kAlphaMin (1 - 2^-21) <= o <= 1: q = fl(kAlphaMin / o) <= (kAlphaMin /
//   o)(1 + u) lies in [kAlphaMin, 1 + 2^-20], so |ln q| < 8 and one ulp of
//   it is <= 2^-21; cut <= ln q + 2^-21 - m + 2^-22 (logf's ulp, then the
//   subtraction's half ulp) <= ln q + 7.2e-7 - m < 0, so x = power < cut
//   and e^x < q e^(7.2e-7 - m);
//   fl(o expf(x)) <= o e^x (1 + 4u)(1 + u)
//                 <  kAlphaMin (1 + u)(1 + 4u)(1 + u) e^(7.2e-7 - m)
//                 <= kAlphaMin e^(1.08e-6 - m) < kAlphaMin
//   for m = kCutMargin = 1e-5 (an underflowing expf is far below it anyway).
// Every evaluation at or above the cut takes the exact path (power, the
// skip test, expf, the clamp, the keep and stop tests), so the pre-test
// changes no skip, keep or stop decision: it only skips, without expf,
// evaluations that could never be kept.
// tests/test_torch_render.py checks the margin on float32 powers just
// below the cut, tests/test_torch_gpu.py with the card's logf and expf and
// through both kernels at powers on either side of the cut.
//
// Rounding: built without fast math and with --fmad=false, using expf, so
// power and alpha round op for op as the plain version's elementwise
// tensors do on the card, and the keep decisions agree with it exactly.
// The transmittance products and colour sums are taken in another order
// there (a running product against a cumprod, a sum against a matmul).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "blend_common.cuh"

namespace blend_fwd {

using namespace blend;

constexpr float kCutMargin = 1e-5f;

// Floats a staged entry's colour takes: ch rounded up to whole float4s.
__host__ __device__ inline int col_stride(int ch) { return (ch + 3) / 4 * 4; }

// Dynamic shared memory of a block staging `batch` entries at `ch` channels.
__host__ __device__ inline size_t shared_bytes(int batch, int ch) {
  return sizeof(float4) * batch * 2 + sizeof(float) * batch * col_stride(ch);
}

struct Shared {
  float4* g0;   // [batch] (x, y, a, b)
  float4* g1;   // [batch] (c, o, cut, 0)
  float* col;   // [batch, col_stride(ch)]
};

__device__ __forceinline__ Shared carve_shared(int batch, int ch) {
  extern __shared__ float4 smem_f4[];
  Shared s;
  s.g0 = smem_f4;
  s.g1 = s.g0 + batch;
  s.col = reinterpret_cast<float*>(s.g1 + batch);
  return s;
}

// One pixel's running state.
// CH > 0: compile-time channel count, colour in registers.
// CH == 0: runtime ch, colour summed in the pixel's own output row.
template <int CH>
struct Pixel {
  float px, py;
  float T;     // transmittance before the next entry
  bool done;   // stopped for good
  float acc[CH > 0 ? CH : 1];
  float* color_row;
};

template <int CH>
__device__ __forceinline__ Pixel<CH> start_pixel(int tile, int grid_w,
                                                 int tile_h, int ch,
                                                 float* out_color) {
  const int lp = threadIdx.x;
  Pixel<CH> p;
  p.px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
  p.py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);
  p.T = 1.0f;
  p.done = false;
  p.color_row = out_color + (static_cast<long long>(tile) * blockDim.x + lp) * ch;
  if constexpr (CH > 0) {
#pragma unroll
    for (int k = 0; k < CH; ++k) p.acc[k] = 0.0f;
  } else {
    for (int k = 0; k < ch; ++k) p.color_row[k] = 0.0f;
  }
  return p;
}

// The pixel's colour and alpha (1 - T) into the outputs.
template <int CH>
__device__ __forceinline__ void finish_pixel(const Pixel<CH>& p, int tile,
                                             float* out_alpha) {
  if constexpr (CH > 0) {
#pragma unroll
    for (int k = 0; k < CH; ++k) p.color_row[k] = p.acc[k];
  }
  out_alpha[static_cast<long long>(tile) * blockDim.x + threadIdx.x] = 1.0f - p.T;
}

// Stages entries [first, first + n) of sort order (n <= blockDim.x), entry
// first + i in slot i. Every thread of the block calls it.
__device__ __forceinline__ void stage(const float* __restrict__ geo,
                                      const float* __restrict__ col,
                                      const int* __restrict__ sort_gauss,
                                      int ch, const Shared& s, int first,
                                      int n) {
  const int lp = threadIdx.x;
  if (lp < n) {
    const int row = sort_gauss[first + lp];
    const float* g = geo + static_cast<long long>(row) * 6;
    const float o = g[5];
    const float cut = o <= 1.0f ? logf(kAlphaMin / o) - kCutMargin : -CUDART_INF_F;
    s.g0[lp] = make_float4(g[0], g[1], g[2], g[3]);
    s.g1[lp] = make_float4(g[4], o, cut, 0.0f);
    const float* cr = col + static_cast<long long>(row) * ch;
    float* dst = s.col + lp * col_stride(ch);
    for (int k = 0; k < ch; ++k) dst[k] = cr[k];
  }
  __syncthreads();
}

// The exact path of one staged entry j that passed the skip and pre-tests,
// at its power: alpha, the keep test, then the stop test or the add.
// Returns true where the pixel stops here (the entry is not added).
template <int CH>
__device__ __forceinline__ bool blend_entry(const Shared& s, Pixel<CH>& p,
                                            int ch, int j, float power) {
  const float alpha = fminf(kAlphaMax, s.g1[j].y * expf(fminf(power, 0.0f)));
  if (alpha < kAlphaMin) return false;
  const float test_T = p.T * (1.0f - alpha);
  if (test_T < kTEps) return true;
  const float w = alpha * p.T;
  if constexpr (CH == 3) {
    const float4 c = reinterpret_cast<const float4*>(s.col)[j];
    p.acc[0] += w * c.x;
    p.acc[1] += w * c.y;
    p.acc[2] += w * c.z;
  } else {
    const int cs = col_stride(ch);
    for (int k = 0; k < ch; ++k) p.color_row[k] += w * s.col[j * cs + k];
  }
  p.T = test_T;
  return false;
}

// Walks the entries [src, src + count) of sort order for the block's tile,
// a batch of blockDim.x at a time. Returns false once every pixel of the
// block has stopped (nothing later can add). Every thread of the block
// calls it with the same arguments.
template <int CH, bool kChunkSkip>
__device__ __forceinline__ bool walk_entries(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, int ch, const Shared& s, Pixel<CH>& p,
    int src, int count) {
  static_assert(CH == 0 || CH == 3, "one float4 of colour at compile time");
  const float skip_eps = kChunkSkip ? 0.0f : 1e-4f;
  for (int base = 0; base < count; base += blockDim.x) {
    // barrier: also keeps the previous batch until every thread is through
    if (__syncthreads_count(!p.done) == 0) return false;
    const int m = min(static_cast<int>(blockDim.x), count - base);
    stage(geo, col, sort_gauss, ch, s, src + base, m);
    for (int j = 0; j < m && !p.done; ++j) {
      const float4 e0 = s.g0[j];  // x, y, a, b
      const float4 e1 = s.g1[j];  // c, o, cut
      const float dx = p.px - e0.x;
      const float dy = p.py - e0.y;
      const float power =
          -0.5f * (e0.z * dx * dx + e1.x * dy * dy) - e0.w * dx * dy;
      if (power > skip_eps || power < e1.z) continue;
      p.done = blend_entry(s, p, ch, j, power);
    }
  }
  return true;
}

}  // namespace blend_fwd
