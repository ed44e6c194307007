// The device body shared by the two backward blend kernels, tile_blend_bwd.cu
// (the tile schedule) and chunk_blend_bwd.cu (the chunk schedule): one block
// per tile, one thread per pixel, walking the tile's entries front to back
// and adding each entry's gradient row straight onto its depth-ordered row
// of g_rows [R, 6 + ch].
//
// The walk follows the forward kernels' rules exactly (skip power > 1e-4 on
// the tile schedule and power > 0 on the chunk schedule, keep alpha >= 1/255,
// a pixel stops for good at the first kept entry with T (1 - alpha) < 1e-4),
// so the backward differentiates what was rendered. The math is the Pallas
// kernels' (sk_gs_tpu/render/tile_kernel.py:606-697): with
// D = sum_k gout_k C_final_k and B_i = sum_k col_ik gout_k, an entry that
// adds gets
//   g_alpha_i = g_alpha_out T_final / (1 - a_i) + B_i T_excl,i
//               - (D - sum_{j <= i} w_j B_j) / (1 - a_i),
//   g_power = alpha_raw g_alpha_i (the 0.99 clamp counts as identity),
//   g_col_i = w_i gout,
// and the conic / position / opacity terms follow from the quadratic form.
// Each pixel carries T, the running sum s_run = sum w B and its stop flag in
// registers from the first entry of its tile to the last.
//
// Entries are staged in shared memory kBatch at a time. For each entry, a
// warp that has an adding pixel sums each of its lanes' 6 + ch terms by
// shuffles into its own slot of s_part [n_warps, kBatch, 6 + ch] and sets
// the entry's bit in its mask; the slots are read only where the bit is
// set, so they are never cleared. (A transposed butterfly, 16 shuffles for
// the nine sums at ch = 3 against 45, ran slower on the H100.) A warp whose
// pixels have all stopped leaves the batch's loop at once. After the batch,
// the block adds the warps' slots of each entry in warp order and adds the
// sum to g_rows[row] with one global atomicAdd a value (red.global.add.f32:
// the result is unused; no padded row stride). An entry that no pixel added to is never touched, so padding
// entries past the tiles' lists and the zero dummy row n leave g_rows as the
// caller zeroed it. The sum inside a block is in a fixed order; the order in
// which the tiles' atomics land varies from run to run, as index_add_'s did,
// so g_rows varies at rounding level between runs.
//
// Rounding: built without fast math and with --fmad=false, using expf, so
// power, alpha and the keep and stop decisions round as in the forward
// kernels and the plain versions.

#pragma once

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace blend_bwd {

using namespace blend;

constexpr int kBatch = 64;  // entries staged per round (one bit each in a mask)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Dynamic shared memory of a block of `threads` pixels at `ch` channels.
__host__ __device__ inline size_t shared_bytes(int threads, int ch) {
  const int n_warps = threads / kWarp;
  return sizeof(unsigned long long) * n_warps +               // masks
         sizeof(float) * kBatch * (1 + 6 + ch) +              // staging
         sizeof(float) * static_cast<size_t>(n_warps) * kBatch * (6 + ch);
}

struct Shared {
  unsigned long long* mask;  // [n_warps]: entries of the batch the warp added to
  int* row;                  // [kBatch] depth-ordered row of each entry
  float *x, *y, *a, *b, *c, *o;  // [kBatch] each
  float* col;                // [kBatch, ch]
  float* part;               // [n_warps, kBatch, 6 + ch]
};

__device__ __forceinline__ Shared carve_shared(int ch, int n_warps) {
  extern __shared__ unsigned long long smem_u64[];
  Shared s;
  s.mask = smem_u64;
  s.row = reinterpret_cast<int*>(smem_u64 + n_warps);
  s.x = reinterpret_cast<float*>(s.row + kBatch);
  s.y = s.x + kBatch;
  s.a = s.y + kBatch;
  s.b = s.a + kBatch;
  s.c = s.b + kBatch;
  s.o = s.c + kBatch;
  s.col = s.o + kBatch;
  s.part = s.col + kBatch * ch;
  return s;
}

// One pixel's forward outputs, cotangents and running state.
// CH > 0: compile-time channel count, g_color row in registers.
// CH == 0: runtime ch, g_color read from its row in device memory.
template <int CH>
struct Pixel {
  float px, py;
  float gout[CH > 0 ? CH : 1];
  const float* gout_row;
  float d_tot;    // D = sum_k gout_k C_final_k
  float t_final;  // 1 - alpha out
  float ga_out;   // cotangent of alpha out
  float T;        // transmittance before the next entry
  float s_run;    // sum of w_j B_j over the entries that added
  bool done;      // stopped for good

  __device__ __forceinline__ float g(int k) const {
    if constexpr (CH > 0) return gout[k];
    return gout_row[k];
  }
};

template <int CH>
__device__ __forceinline__ Pixel<CH> load_pixel(
    int tile, int grid_w, int tile_h, int ch, const float* tile_color,
    const float* tile_alpha, const float* g_color, const float* g_alpha) {
  const int lp = threadIdx.x;
  Pixel<CH> p;
  p.px = static_cast<float>((tile % grid_w) * kTile + lp % kTile);
  p.py = static_cast<float>((tile / grid_w) * tile_h + lp / kTile);
  const long long pix = static_cast<long long>(tile) * blockDim.x + lp;
  p.gout_row = g_color + pix * ch;
  p.d_tot = 0.0f;
  for (int k = 0; k < ch; ++k) {
    const float gk = p.gout_row[k];
    if constexpr (CH > 0) p.gout[k] = gk;
    p.d_tot += gk * tile_color[pix * ch + k];
  }
  p.t_final = 1.0f - tile_alpha[pix];
  p.ga_out = g_alpha[pix];
  p.T = 1.0f;
  p.s_run = 0.0f;
  p.done = false;
  return p;
}

// Walks the entries [begin, begin + count) of sort order for the block's
// tile, adding each entry's row onto g_rows. Returns false once every pixel
// of the block has stopped (nothing later can add). Every thread of the
// block calls it with the same arguments.
template <int CH, bool kChunkSkip>
__device__ __forceinline__ bool walk_entries(
    const float* __restrict__ geo, const float* __restrict__ col,
    const int* __restrict__ sort_gauss, float* __restrict__ g_rows, int ch,
    const Shared& s, Pixel<CH>& p, int begin, int count) {
  const float skip_eps = kChunkSkip ? 0.0f : 1e-4f;
  const int nv = 6 + ch;
  const int lp = threadIdx.x;
  const int P = blockDim.x;
  const int lane = lp % kWarp;
  const int warp = lp / kWarp;
  const int n_warps = P / kWarp;

  for (int base = 0; base < count; base += kBatch) {
    // barrier: also keeps the previous batch's slots until they are summed
    if (__syncthreads_count(!p.done) == 0) return false;
    const int n = min(kBatch, count - base);
    if (lp < n) {
      const int row = sort_gauss[begin + base + lp];
      s.row[lp] = row;
      const float* g = geo + static_cast<long long>(row) * 6;
      s.x[lp] = g[0];
      s.y[lp] = g[1];
      s.a[lp] = g[2];
      s.b[lp] = g[3];
      s.c[lp] = g[4];
      s.o[lp] = g[5];
      const float* cr = col + static_cast<long long>(row) * ch;
      for (int k = 0; k < ch; ++k) s.col[lp * ch + k] = cr[k];
    }
    __syncthreads();

    unsigned long long mask = 0;
    for (int j = 0; j < n; ++j) {
      if (!__any_sync(kFull, !p.done)) break;  // the whole warp has stopped
      const float a = s.a[j], b = s.b[j], c = s.c[j], o = s.o[j];
      const float dx = p.px - s.x[j];
      const float dy = p.py - s.y[j];
      const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
      bool adds = false;
      float w = 0.0f, g_power = 0.0f;
      if (!p.done && power <= skip_eps) {
        const float alpha_raw = o * expf(fminf(power, 0.0f));
        const float alpha = fminf(kAlphaMax, alpha_raw);
        if (alpha >= kAlphaMin) {
          const float om = 1.0f - alpha;
          const float test_T = p.T * om;
          if (test_T < kTEps) {
            p.done = true;
          } else {
            w = alpha * p.T;
            float bsum = 0.0f;  // B = sum_k col_k gout_k
            for (int k = 0; k < ch; ++k) bsum += s.col[j * ch + k] * p.g(k);
            p.s_run += w * bsum;
            const float inv_om = 1.0f / om;
            const float g_alpha_i = p.ga_out * p.t_final * inv_om +
                                    bsum * p.T - (p.d_tot - p.s_run) * inv_om;
            g_power = alpha_raw * g_alpha_i;
            p.T = test_T;
            adds = true;
          }
        }
      }
      if (!__any_sync(kFull, adds)) continue;  // the slot is not marked
      mask |= 1ull << j;
      const float inv_o = o > 0.0f ? 1.0f / fmaxf(o, 1e-12f) : 0.0f;
      float* slot = s.part + (static_cast<long long>(warp) * kBatch + j) * nv;
      float vals[6];
      vals[0] = (a * dx + b * dy) * g_power;
      vals[1] = (c * dy + b * dx) * g_power;
      vals[2] = -0.5f * dx * dx * g_power;
      vals[3] = -dx * dy * g_power;
      vals[4] = -0.5f * dy * dy * g_power;
      vals[5] = g_power * inv_o;
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        const float t = warp_sum(adds ? vals[v] : 0.0f);
        if (lane == 0) slot[v] = t;
      }
      for (int k = 0; k < ch; ++k) {
        const float t = warp_sum(w * p.g(k));
        if (lane == 0) slot[6 + k] = t;
      }
    }
    if (lane == 0) s.mask[warp] = mask;
    __syncthreads();

    // each marked entry's row: the warps' slots in warp order, then one
    // atomic add a value onto its depth-ordered row
    for (int i = lp; i < n * nv; i += P) {
      const int j = i / nv;
      const int v = i - j * nv;
      float acc = 0.0f;
      bool any = false;
      for (int wi = 0; wi < n_warps; ++wi) {
        if ((s.mask[wi] >> j) & 1ull) {
          acc += s.part[(static_cast<long long>(wi) * kBatch + j) * nv + v];
          any = true;
        }
      }
      if (any) atomicAdd(g_rows + static_cast<long long>(s.row[j]) * nv + v, acc);
    }
  }
  return true;
}

}  // namespace blend_bwd
