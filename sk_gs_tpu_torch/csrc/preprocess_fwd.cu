// Per-Gaussian preprocess for Hopper (sm_90a), plain C interface loaded with
// ctypes: the projection, the EWA 2D covariance and its conic, the 3-sigma
// radius and the opacity-aware rects in tiles, the SH colour, for every
// capacity row in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the preprocess to XLA
// (sk_gs_tpu/render/preprocess.py), and the port's plain version,
// sk_gs_tpu_torch/render/preprocess.py:preprocess_plain, is about 390 small
// PyTorch operations over the N rows. On the card those are 390 launches a
// request, and the host's time to launch them, not the card's work, set the
// pace of a served request. This kernel is those operations in one launch.
//
// What bounds it: bytes. A row reads about 237 B (means 12, scales 12,
// rotation 16, opacity 4, SH 192 at degree 3, mask 1) and writes about
// 65 B, against some 400 floating-point operations: at 100,352 rows about
// 30 MB, ~9 us at 3.35 TB/s.
//
// Design. One thread per row, kRows rows a block. The SH block is 64% of
// the bytes; a thread reading its own row's 48 floats would walk memory at
// a 192-byte stride, a sector per lane per load. So the block first copies
// its rows' contiguous [rows, bases, channels] slab into shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses, while its
// first thread builds the view's constants (full_proj = Tv2c @ Tw2v, fx,
// fy, the clamp limits, the active SH degree) from device pointers: the
// wrapper reads nothing on the host. Each thread then evaluates its row
// from shared memory. The kernel is templated on the SH degree (0 to 3);
// colours given in place of SH, a missing mask and tight culling off are
// flags.
//
// Rounding: built without fast math and with --fmad=false, the elementwise
// operations are the plain version's, in its order, each rounded once as
// its PyTorch kernel rounds it on the card: a Python scalar becomes a
// float32 constant, `scalar / tensor` is a reciprocal times the scalar,
// `tensor / int` a product with the float32 reciprocal (PyTorch's CUDA
// division by a host scalar), clamp, minimum and maximum pass NaN on, and
// float -> int32 is XLA's (truncation, saturation, NaN -> 0). The products
// the plain version leaves to cuBLAS (p_view, p_hom, w and full_proj) are
// fused multiply-add chains in k order here; cuBLAS may take another order,
// so those and what follows from them agree to rounding, and an integer
// field can differ only where a float edge lies at rounding distance from a
// tile boundary or an integer radius (tests/test_torch_preprocess_kernel.py
// counts those rows).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows (threads) a block
constexpr int kTile = 16;   // pixels per tile in x

// Python's float constants as PyTorch casts them: double -> float32.
__device__ __forceinline__ constexpr float f32(double x) {
  return static_cast<float>(x);
}

struct Params {
  const float* means3d;     // [N, 3]
  const float* scales;      // [N, 3]
  const float* rotations;   // [N, 4] (x, y, z, w)
  const float* opacities;   // [N]
  const float* sh;          // [N, n_bases, channels], or null: colours given
  const uint8_t* mask;      // [N] bool, or null
  const float* Tw2v;        // [4, 4]
  const float* Tv2c;        // [4, 4]
  const float* campos;      // [3]
  const float* tan_fovx;    // []
  const float* tan_fovy;    // []
  const int* active;        // [] int32, or null: every band
  float* means2d;           // [N, 2]
  float* depths;            // [N]
  float* conic;             // [N, 3]
  float* colors;            // [N, channels], unused without sh
  int* radius;              // [N]
  int* tiles_touched;       // [N]
  int* rect_min;            // [N, 2]
  int* rect_max;            // [N, 2]
  uint8_t* visible;         // [N] bool
  float* tau;               // [N]
  int n, n_bases, channels, image_width, image_height, grid_w, grid_h,
      tile_h, tight;
  float near, scale_modifier;
};

// What every row of the view shares, built once a block.
struct ViewConst {
  float R[9];   // Tw2v[:3, :3], row-major
  float t[3];   // Tw2v[:3, 3]
  float P[16];  // full_proj = Tv2c @ Tw2v, row-major
  float campos[3];
  float fx, fy, lim_x, lim_y;
  int active;   // SH bands above it are masked out
};

__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float minimum_f(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// float -> int32 as XLA converts (render/preprocess.py:to_int32).
__device__ __forceinline__ int to_int32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return __float2int_rz(x);
}

__device__ __forceinline__ int clamp_i(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ ViewConst view_const(const Params& p) {
  ViewConst v;
  const float* A = p.Tv2c;
  const float* B = p.Tw2v;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) v.R[3 * r + c] = B[4 * r + c];
    v.t[r] = B[4 * r + 3];
    v.campos[r] = p.campos[r];
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      float acc = A[4 * i] * B[j];
      for (int k = 1; k < 4; ++k) acc = fmaf(A[4 * i + k], B[4 * k + j], acc);
      v.P[4 * i + j] = acc;
    }
  }
  const float tx = *p.tan_fovx, ty = *p.tan_fovy;
  // cfg.image_width / (2.0 * tan_fovx): the reciprocal times the width
  v.fx = (1.0f / (2.0f * tx)) * static_cast<float>(p.image_width);
  v.fy = (1.0f / (2.0f * ty)) * static_cast<float>(p.image_height);
  v.lim_x = f32(1.3) * tx;
  v.lim_y = f32(1.3) * ty;
  v.active = p.active != nullptr ? *p.active : 2147483647;
  return v;
}

// sh_to_color's sum for one channel of the staged row s (stride `ch`
// between bases), each base already times its band mask m[k]; the order
// of ops/sh.py:eval_sh.
template <int DEG>
__device__ __forceinline__ float eval_sh(const float* s, int ch,
                                         const float* m, float x, float y,
                                         float z) {
  float r = f32(0.28209479177387814) * (s[0] * m[0]);
  if constexpr (DEG >= 1) {
    const float c1 = f32(0.4886025119029199);
    r = r - (c1 * y) * (s[ch] * m[1]);
    r = r + (c1 * z) * (s[2 * ch] * m[2]);
    r = r - (c1 * x) * (s[3 * ch] * m[3]);
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    r = r + (f32(1.0925484305920792) * xy) * (s[4 * ch] * m[4]);
    r = r + (f32(-1.0925484305920792) * yz) * (s[5 * ch] * m[5]);
    r = r + (f32(0.31539156525252005) * ((2.0f * zz - xx) - yy)) *
                (s[6 * ch] * m[6]);
    r = r + (f32(-1.0925484305920792) * xz) * (s[7 * ch] * m[7]);
    r = r + (f32(0.5462742152960396) * (xx - yy)) * (s[8 * ch] * m[8]);
    if constexpr (DEG >= 3) {
      r = r + ((f32(-0.5900435899266435) * y) * (3.0f * xx - yy)) *
                  (s[9 * ch] * m[9]);
      r = r + ((f32(2.890611442640554) * xy) * z) * (s[10 * ch] * m[10]);
      r = r + ((f32(-0.4570457994644658) * y) * ((4.0f * zz - xx) - yy)) *
                  (s[11 * ch] * m[11]);
      r = r + ((f32(0.3731763325901154) * z) *
               ((2.0f * zz - 3.0f * xx) - 3.0f * yy)) *
                  (s[12 * ch] * m[12]);
      r = r + ((f32(-0.4570457994644658) * x) * ((4.0f * zz - xx) - yy)) *
                  (s[13 * ch] * m[13]);
      r = r + ((f32(1.445305721320277) * z) * (xx - yy)) *
                  (s[14 * ch] * m[14]);
      r = r + ((f32(-0.5900435899266435) * x) * (xx - 3.0f * yy)) *
                  (s[15 * ch] * m[15]);
    }
  }
  return r;
}

template <int DEG>
__global__ void __launch_bounds__(kRows)
    preprocess_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  __shared__ ViewConst vc;

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.n - row0);
  const int stride = p.n_bases * p.channels;  // floats a row of SH
  if (p.sh != nullptr) {
    const float* src = p.sh + static_cast<size_t>(row0) * stride;
    const int count = rows * stride;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      const int n4 = count >> 2;
      for (int j = threadIdx.x; j < n4; j += blockDim.x) smem4[j] = src4[j];
      done = n4 << 2;
    }
    for (int j = done + threadIdx.x; j < count; j += blockDim.x)
      slab[j] = src[j];
  }
  if (threadIdx.x == 0) vc = view_const(p);
  __syncthreads();

  const int i = row0 + threadIdx.x;
  if (i >= p.n) return;

  // project_points: the products as fused chains (cuBLAS), then + t
  const float mx = p.means3d[3 * i], my = p.means3d[3 * i + 1],
              mz = p.means3d[3 * i + 2];
  float pv[3], ph[3];
  for (int c = 0; c < 3; ++c) {
    pv[c] = fmaf(mz, vc.R[3 * c + 2], fmaf(my, vc.R[3 * c + 1],
                                            mx * vc.R[3 * c])) + vc.t[c];
    ph[c] = fmaf(mz, vc.P[4 * c + 2], fmaf(my, vc.P[4 * c + 1],
                                            mx * vc.P[4 * c])) + vc.P[4 * c + 3];
  }
  const float w = fmaf(mz, vc.P[14], fmaf(my, vc.P[13], mx * vc.P[12])) +
                  vc.P[15];
  const float inv_w = 1.0f / (w + f32(1e-7));
  const float ndc_x = ph[0] * inv_w, ndc_y = ph[1] * inv_w;
  const bool in_front = pv[2] > p.near;

  // compute_cov3d: R S^2 R^T of the normalised quaternion
  float qx = p.rotations[4 * i], qy = p.rotations[4 * i + 1],
        qz = p.rotations[4 * i + 2], qw = p.rotations[4 * i + 3];
  const float qn = sqrtf((((qx * qx + qy * qy) + qz * qz) + qw * qw) +
                         f32(1e-12 * 1e-12));
  qx = qx / qn; qy = qy / qn; qz = qz / qn; qw = qw / qn;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float Rq[9] = {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz),
                       2.0f * (xz + wy),        2.0f * (xy + wz),
                       1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx),
                       2.0f * (xz - wy),        2.0f * (yz + wx),
                       1.0f - 2.0f * (xx + yy)};
  float s2[3];
  for (int j = 0; j < 3; ++j) {
    const float s = p.scales[3 * i + j] * p.scale_modifier;
    s2[j] = s * s;
  }
  float cov[6];  // (xx, xy, xz, yy, yz, zz)
  {
    int o = 0;
    for (int a = 0; a < 3; ++a) {
      for (int b = a; b < 3; ++b) {
        float acc = (Rq[3 * a] * s2[0]) * Rq[3 * b];
        acc = acc + (Rq[3 * a + 1] * s2[1]) * Rq[3 * b + 1];
        acc = acc + (Rq[3 * a + 2] * s2[2]) * Rq[3 * b + 2];
        cov[o++] = acc;
      }
    }
  }
  const float sxx = cov[0], sxy = cov[1], sxz = cov[2], syy = cov[3],
              syz = cov[4], szz = cov[5];

  // compute_cov2d: the EWA Jacobian, clamped to 1.3 x the field of view
  const float tz = pv[2];
  const float tx = clamp_f(pv[0] / tz, -vc.lim_x, vc.lim_x) * tz;
  const float ty = clamp_f(pv[1] / tz, -vc.lim_y, vc.lim_y) * tz;
  const float inv_z = 1.0f / tz;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = vc.fx * inv_z;
  const float j02 = (-vc.fx * tx) * inv_z2;
  const float j11 = vc.fy * inv_z;
  const float j12 = (-vc.fy * ty) * inv_z2;
  float a0[3], a1[3];
  for (int k = 0; k < 3; ++k) {
    a0[k] = j00 * vc.R[k] + j02 * vc.R[6 + k];
    a1[k] = j11 * vc.R[3 + k] + j12 * vc.R[6 + k];
  }
  const float b00 = (a0[0] * sxx + a0[1] * sxy) + a0[2] * sxz;
  const float b01 = (a0[0] * sxy + a0[1] * syy) + a0[2] * syz;
  const float b02 = (a0[0] * sxz + a0[1] * syz) + a0[2] * szz;
  const float b10 = (a1[0] * sxx + a1[1] * sxy) + a1[2] * sxz;
  const float b11 = (a1[0] * sxy + a1[1] * syy) + a1[2] * syz;
  const float b12 = (a1[0] * sxz + a1[1] * syz) + a1[2] * szz;
  const float low_pass = f32(0.3);
  const float cxx = ((b00 * a0[0] + b01 * a0[1]) + b02 * a0[2]) + low_pass;
  const float cyy = ((b10 * a1[0] + b11 * a1[1]) + b12 * a1[2]) + low_pass;
  const float cxy = (b00 * a1[0] + b01 * a1[1]) + b02 * a1[2];

  // the conic and the 3-sigma radius
  const float det = cxx * cyy - cxy * cxy;
  const bool det_valid = det != 0.0f;
  const float inv_det = 1.0f / (det_valid ? det : 1.0f);
  const float mid = 0.5f * (cxx + cyy);
  const float disc = sqrtf(clamp_min_f(mid * mid - det, f32(0.1)));
  const float lam_max = mid + disc;
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min_f(lam_max, 0.0f)));

  const float px =
      ((ndc_x + 1.0f) * static_cast<float>(p.image_width) - 1.0f) * 0.5f;
  const float py =
      ((ndc_y + 1.0f) * static_cast<float>(p.image_height) - 1.0f) * 0.5f;

  // o exp(-q / 2) >= 1/255  <=>  q <= tau
  const float tau = 2.0f * clamp_min_f(logf(255.0f * p.opacities[i]), 0.0f);
  float rx = radius_f, ry = radius_f;
  if (p.tight) {
    rx = minimum_f(ceilf(sqrtf(tau * cxx)), radius_f);
    ry = minimum_f(ceilf(sqrtf(tau * cyy)), radius_f);
  }

  // the rects in tiles: `tensor / int` on the card is a product with the
  // float32 reciprocal
  const float th = static_cast<float>(p.tile_h);
  const float inv_tw = 1.0f / static_cast<float>(kTile);
  const float inv_th = 1.0f / th;
  const int rnx = clamp_i(to_int32((px - rx) * inv_tw), p.grid_w);
  const int rny = clamp_i(to_int32((py - ry) * inv_th), p.grid_h);
  const int rmx = clamp_i(
      to_int32((((px + rx) + static_cast<float>(kTile)) - 1.0f) * inv_tw),
      p.grid_w);
  const int rmy = clamp_i(to_int32((((py + ry) + th) - 1.0f) * inv_th),
                          p.grid_h);
  const int area = (rmx - rnx) * (rmy - rny);

  bool visible = in_front && det_valid && area > 0;
  if (p.mask != nullptr) visible = visible && p.mask[i] != 0;

  p.means2d[2 * i] = px;
  p.means2d[2 * i + 1] = py;
  p.depths[i] = visible ? tz : CUDART_INF_F;
  p.conic[3 * i] = cyy * inv_det;
  p.conic[3 * i + 1] = -cxy * inv_det;
  p.conic[3 * i + 2] = cxx * inv_det;
  p.radius[i] = to_int32(visible ? radius_f : 0.0f);
  p.tiles_touched[i] = visible ? area : 0;
  p.rect_min[2 * i] = rnx;
  p.rect_min[2 * i + 1] = rny;
  p.rect_max[2 * i] = rmx;
  p.rect_max[2 * i + 1] = rmy;
  p.visible[i] = visible ? 1 : 0;
  p.tau[i] = tau;

  if (p.sh == nullptr) return;
  // sh_to_color: the normalised view direction, +0.5, clamped at 0
  const float dx = mx - vc.campos[0], dy = my - vc.campos[1],
              dz = mz - vc.campos[2];
  const float nrm =
      clamp_min_f(sqrtf((dx * dx + dy * dy) + dz * dz), f32(1e-12));
  const float ux = dx / nrm, uy = dy / nrm, uz = dz / nrm;
  constexpr int kBases = (DEG + 1) * (DEG + 1);
  float m[kBases];
  for (int k = 0; k < kBases; ++k) {
    const int band = static_cast<int>(floorf(sqrtf(static_cast<float>(k))));
    m[k] = band <= vc.active ? 1.0f : 0.0f;
  }
  const float* s = slab + threadIdx.x * stride;
  for (int c = 0; c < p.channels; ++c) {
    const float r = eval_sh<DEG>(s + c, p.channels, m, ux, uy, uz) + 0.5f;
    p.colors[static_cast<size_t>(i) * p.channels + c] = clamp_min_f(r, 0.0f);
  }
}

size_t shared_bytes(const Params& p) {
  return p.sh == nullptr ? 0
                         : sizeof(float) * kRows * p.n_bases * p.channels;
}

template <int DEG>
cudaError_t allow_shared(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(preprocess_fwd_kernel<DEG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DEG>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p);
  cudaError_t err = allow_shared<DEG>(smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.n + kRows - 1) / kRows;
  preprocess_fwd_kernel<DEG><<<blocks, kRows, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DEG>
cudaError_t occupancy(size_t smem, int* blocks) {
  cudaError_t err = allow_shared<DEG>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, preprocess_fwd_kernel<DEG>, kRows, smem);
}

}  // namespace

// Inputs: means3d [N, 3], scales [N, 3], rotations [N, 4], opacities [N],
// sh [N, n_bases, channels] (null: colours given, nothing written to
// colors), mask [N] bool (null: every row live), the view's Tw2v and Tv2c
// [4, 4], campos [3], tan_fovx and tan_fovy [], active_sh_degree [] int32
// (null: every band); all float32 but the mask and the degree, contiguous,
// on the device. Outputs (every value written):
// means2d [N, 2], depths [N], conic [N, 3], colors [N, channels], radius,
// tiles_touched [N] int32, rect_min, rect_max [N, 2] int32, visible [N]
// bool, tau [N]. sh_degree in 0..3, n_bases >= (sh_degree + 1)^2. Launches
// on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int preprocess_fwd(
    const float* means3d, const float* scales, const float* rotations,
    const float* opacities, const float* sh, const uint8_t* mask,
    const float* Tw2v, const float* Tv2c, const float* campos,
    const float* tan_fovx, const float* tan_fovy, const int* active,
    float* means2d, float* depths, float* conic, float* colors, int* radius,
    int* tiles_touched, int* rect_min, int* rect_max, uint8_t* visible,
    float* tau, int n, int sh_degree, int n_bases, int channels,
    int image_width, int image_height, int grid_w, int grid_h, int tile_h,
    int tight, float near, float scale_modifier,
    void* stream) {
  if (n == 0) return 0;
  const Params p{means3d, scales, rotations, opacities, sh, mask, Tw2v,
                 Tv2c, campos, tan_fovx, tan_fovy, active, means2d, depths,
                 conic, colors, radius, tiles_touched, rect_min, rect_max,
                 visible, tau, n, n_bases, channels, image_width,
                 image_height, grid_w, grid_h, tile_h, tight, near,
                 scale_modifier};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (sh == nullptr ? 0 : sh_degree) {
    case 0: err = launch<0>(p, s); break;
    case 1: err = launch<1>(p, s); break;
    case 2: err = launch<2>(p, s); break;
    case 3: err = launch<3>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Blocks of preprocess_fwd's kernel resident on one SM at this SH degree
// and SH row width (n_bases x channels floats; 0 when colours are given),
// into *blocks; returns the CUDA error (0 = ok).
extern "C" int preprocess_fwd_occupancy(int sh_degree, int row_floats,
                                        int* blocks) {
  const size_t smem = sizeof(float) * kRows * row_floats;
  cudaError_t err;
  switch (sh_degree) {
    case 0: err = occupancy<0>(smem, blocks); break;
    case 1: err = occupancy<1>(smem, blocks); break;
    case 2: err = occupancy<2>(smem, blocks); break;
    case 3: err = occupancy<3>(smem, blocks); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* preprocess_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
