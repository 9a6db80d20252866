// Index fields of the LSS sampling view transform, on the device: for one
// camera and one BEV cell, the image row j*, depth bin kd* and image column
// i* that omnihd_scenes_tpu_torch/kernels/lss_sample.py:_sample_indices
// gives (the port of omnihd_scenes_tpu/ops/lss_project.py:_sample_indices).
//
// Every operation is the plain PyTorch version's, in its order, rounded as
// PyTorch's CUDA elementwise kernels round it: each multiply, add, subtract
// and divide is its own kernel there, so it is written here with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never contracts
// into an FMA.  The Python-float constants arrive as the f32 values those
// kernels use (GeomConsts); the f32 coordinate tables ys / xc / yc / zc
// arrive as device arrays.  The indices are then identical to the plain
// version run on the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lss {

// The index math's Python-float constants as f32, as PyTorch's CUDA ops
// see them: a scalar operand of a compare, multiply or subtract is cast to
// f32; a division by a Python scalar is a multiply by the f32 reciprocal
// (f32(1) / f32(dd), computed in f32 on the host).
struct GeomConsts {
  float d_floor;  // max(1e-3, d0 / 2)
  float d0;
  float inv_dd;   // f32(1) / f32(dd)
  float u_scale;  // (fW - 1) / max(W - 1, 1)
  float v_scale;  // (fH - 1) / max(H - 1, 1)
  float w_lim;    // W - 0.5
  float h_lim;    // H - 0.5
};

// One camera's coefficients in its own orientation: for solve_x cameras
// the solved coordinate is x and the column coordinate y, for side cameras
// the reverse.  Row a of the lidar->image map (minv, mt).
struct CamCoef {
  float a[3];   // minv[a][0] (solve_x) or minv[a][1]: the solved coordinate
  float f[3];   // minv[a][1] (solve_x) or minv[a][0]: the column coordinate
  float m2[3];  // minv[a][2]: z
  float t[3];   // mt[a]
};

constexpr int kCamCoefFloats = 12;

__device__ __forceinline__ CamCoef cam_coef(const float* minv, const float* mt,
                                            bool solve_x) {
  CamCoef c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c.a[a] = minv[3 * a + (solve_x ? 0 : 1)];
    c.f[a] = minv[3 * a + (solve_x ? 1 : 0)];
    c.m2[a] = minv[3 * a + 2];
    c.t[a] = mt[a];
  }
  return c;
}

// _safe_div: a / b with |b| < eps replaced by +-eps (sign of b, +eps at 0).
__device__ __forceinline__ float safe_div(float a, float b) {
  const float eps = 1e-6f;
  const float bs = fabsf(b) < eps ? (b < 0.f ? -eps : eps) : b;
  return __fdiv_rn(a, bs);
}

// _clean_idx: where(valid & isfinite(x), x, -1e9), round half to even,
// clamp to [-1, 1e9], int32.
__device__ __forceinline__ int clean_idx(float x, bool valid) {
  const float v = (valid && isfinite(x)) ? x : -1e9f;
  return (int)fminf(fmaxf(rintf(v), -1.f), 1e9f);
}

// cc[a] = fixed_a * bc + Minv[a, 2] * zc + mt_a at the cell's (z, b).
__device__ __forceinline__ void column_coords(const CamCoef& c, float bc,
                                              float zc, float cc[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cc[a] = __fadd_rn(__fadd_rn(__fmul_rn(c.f[a], bc), __fmul_rn(c.m2[a], zc)),
                      c.t[a]);
}

// Pass 2: the full projection at the cell (z, b, g) -> j*, kd*.
__device__ __forceinline__ void pass2(const CamCoef& c, const float cc[3],
                                      float gc, const GeomConsts& k, int* j,
                                      int* kd) {
  const float d = __fadd_rn(__fmul_rn(c.a[2], gc), cc[2]);
  const float q1 = __fadd_rn(__fmul_rn(c.a[1], gc), cc[1]);
  const float vs = safe_div(q1, d);
  const bool ok = d > k.d_floor && vs > -0.5f && vs < k.h_lim;
  *j = clean_idx(__fmul_rn(vs, k.v_scale), ok);
  *kd = clean_idx(__fmul_rn(__fsub_rn(d, k.d0), k.inv_dd), ok);
}

// Pass 1 at image row v = ys[j*] and the cell's (z, b): solve q1/q2 = v
// for the free coordinate s, then the image column -> i*.
__device__ __forceinline__ int pass1(const CamCoef& c, const float cc[3],
                                     float v, const GeomConsts& k) {
  const float denom = __fsub_rn(c.a[1], __fmul_rn(v, c.a[2]));
  const float s = safe_div(__fsub_rn(__fmul_rn(v, cc[2]), cc[1]), denom);
  const float q2s = __fadd_rn(__fmul_rn(c.a[2], s), cc[2]);
  const float us = safe_div(__fadd_rn(__fmul_rn(c.a[0], s), cc[0]), q2s);
  const bool ok = q2s > k.d_floor && us > -0.5f && us < k.w_lim;
  return clean_idx(__fmul_rn(us, k.u_scale), ok);
}

// (j*, i*, kd*) of one camera at one cell: bc / gc are the cell's column /
// solved coordinate (yc[y] / xc[x] for solve_x cameras, xc[x] / yc[y] for
// side cameras).  i* is pass 1 read at the cell's row j*, as the fields
// path reads i_star[j*, z, b]; it is -1 (not evaluated) where j* or kd* is
// out of range, since no reader uses it there.
__device__ __forceinline__ void cell_indices(const CamCoef& c, float bc,
                                             float gc, float zc,
                                             const float* ys, int f_h,
                                             int d_bins, const GeomConsts& k,
                                             int* j, int* i, int* kd) {
  float cc[3];
  column_coords(c, bc, zc, cc);
  pass2(c, cc, gc, k, j, kd);
  *i = -1;
  if (*j >= 0 && *j < f_h && *kd >= 0 && *kd < d_bins)
    *i = pass1(c, cc, __ldg(ys + *j), k);
}

}  // namespace lss
