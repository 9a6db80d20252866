// The photometric training jitter for Hopper, sm_90a: one elementwise pass
// over a batch of normalised f32 camera images (N, H, W, 3), each image by
// its row of drawn parameters.  No TPU kernel is replaced: the JAX package
// jitters its images on the host in NumPy
// (omnihd_scenes_tpu/data/augmentation.py:55-110 photometric_distortion);
// the port draws the parameters on the host with the same RandomState
// calls and applies them here.  kernels/photometric.py holds the wrapper
// and the plain PyTorch version, step for step.
//
// Per pixel, in NumPy's f32 order: x * std + mean; + brightness; * contrast
// (mode 1); RGB -> HSV in OpenCV's float convention (v = max, c = v - min,
// s = c / v where v > 0, h from the channel that holds the max, r before
// g, times 60, np.mod 360); s * saturation; h = np.mod(h + hue, 360); HSV
// -> RGB (h60 = np.mod(h, 360) / 60, sector floor(h60) mod 6, p / q / t);
// * contrast (mode 0); the channel permutation; (x - mean) / std.  Every
// operation is a round-to-nearest intrinsic, so nothing is contracted into
// a fused multiply-add, and np.mod is fmodf (exact) then + 360 where
// negative and +0 where zero: the result is NumPy's bit for bit.
//
// Params (n_img, 13) f32 rows (data/augmentation.py PHOTOMETRIC_FIELDS):
// brightness flag, delta, mode, contrast flag, alpha, saturation flag,
// alpha, hue flag, delta, swap flag, the permutation's three channels.
//
// Bound: bytes, 12 in and 12 out a pixel, ~100 f32 operations (eight
// IEEE divisions, each a short instruction sequence): below the card's
// operations-to-bytes balance, but not by much.  Design: one thread a
// pixel, the image on gridDim.y, so a block reads one image's row (the
// same address for every thread: a broadcast) and no thread divides a
// 64-bit index; np.mod's fmodf is skipped on [0, 720), where it is the
// value itself or an exact subtraction (Sterbenz).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 13;

__device__ __forceinline__ float py_mod360(float a) {
  // fmodf(a, 360) is a on [0, 360) and a - 360, exactly, on [360, 720).
  float m = a >= 0.f && a < 360.f ? a
          : a >= 360.f && a < 720.f ? __fsub_rn(a, 360.f)
                                     : fmodf(a, 360.f);
  if (m < 0.f) m = __fadd_rn(m, 360.f);
  else if (m == 0.f) m = 0.f;
  return m;
}

__global__ void __launch_bounds__(kThreads)
photometric_kernel(const float* __restrict__ imgs,
                   const float* __restrict__ params, long long hw,
                   float m0, float m1, float m2, float s0, float s1,
                   float s2, float* __restrict__ out) {
  const float mean[3] = {m0, m1, m2};
  const float stdv[3] = {s0, s1, s2};
  const long long px = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (px < hw) {
    const long long i = blockIdx.y * hw + px;
    const float* p = params + blockIdx.y * kFields;
    const float bright = __ldg(p + 0), delta = __ldg(p + 1);
    const float mode = __ldg(p + 2), contrast = __ldg(p + 3);
    const float alpha = __ldg(p + 4), sat = __ldg(p + 5);
    const float sat_alpha = __ldg(p + 6), hue = __ldg(p + 7);
    const float hue_delta = __ldg(p + 8), swap = __ldg(p + 9);

    float x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = __fadd_rn(__fmul_rn(imgs[i * 3 + c], stdv[c]), mean[c]);
      if (bright != 0.f) x[c] = __fadd_rn(x[c], delta);
      if (mode == 1.f && contrast != 0.f) x[c] = __fmul_rn(x[c], alpha);
    }

    // RGB -> HSV (augmentation.py rgb_to_hsv).
    const float r = x[0], g = x[1], b = x[2];
    const float v = fmaxf(fmaxf(r, g), b);
    const float mn = fminf(fminf(r, g), b);
    const float c = __fsub_rn(v, mn);
    const float safe_c = c > 0.f ? c : 1.f;
    float s = v > 0.f ? __fdiv_rn(c, v) : 0.f;
    float h;
    if (c == 0.f) {
      h = 0.f;
    } else if (v == r) {
      h = __fmul_rn(__fdiv_rn(__fsub_rn(g, b), safe_c), 60.f);
    } else if (v == g) {
      h = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(b, r), safe_c), 60.f),
                    120.f);
    } else {
      h = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(r, g), safe_c), 60.f),
                    240.f);
    }
    h = py_mod360(h);
    if (sat != 0.f) s = __fmul_rn(s, sat_alpha);
    if (hue != 0.f) h = py_mod360(__fadd_rn(h, hue_delta));

    // HSV -> RGB (augmentation.py hsv_to_rgb).
    const float h60 = __fdiv_rn(py_mod360(h), 60.f);
    const float fl = floorf(h60);
    int sector = static_cast<int>(fl) % 6;
    if (sector < 0) sector += 6;
    const float f = __fsub_rn(h60, fl);
    const float pp = __fmul_rn(v, __fsub_rn(1.f, s));
    const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(f, s)));
    const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(__fsub_rn(1.f, f),
                                                          s)));
    float o[3];
    switch (sector) {
      case 0: o[0] = v; o[1] = t; o[2] = pp; break;
      case 1: o[0] = q; o[1] = v; o[2] = pp; break;
      case 2: o[0] = pp; o[1] = v; o[2] = t; break;
      case 3: o[0] = pp; o[1] = q; o[2] = v; break;
      case 4: o[0] = t; o[1] = pp; o[2] = v; break;
      default: o[0] = v; o[1] = pp; o[2] = q; break;
    }
    if (mode == 0.f && contrast != 0.f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = __fmul_rn(o[k], alpha);
    }
    float y[3] = {o[0], o[1], o[2]};
    if (swap != 0.f) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        y[k] = o[static_cast<int>(__ldg(p + 10 + k))];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[i * 3 + k] = __fdiv_rn(__fsub_rn(y[k], mean[k]), stdv[k]);
  }
}

}  // namespace

// One launch over a batch: imgs and out (n_img * hw * 3) f32 on the card,
// params (n_img, 13) f32 on the card, mean / std the normalisation's.
// Returns a cudaError_t (0 on success).
extern "C" int photometric_launch(const void* imgs, const void* params,
                                  int n_img, long long hw, float m0, float m1,
                                  float m2, float s0, float s1, float s2,
                                  void* out, void* stream) {
  if (n_img <= 0 || hw <= 0) return 0;
  const long long blocks = (hw + kThreads - 1) / kThreads;
  if (n_img > 65535 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_img));
  photometric_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(params), hw,
      m0, m1, m2, s0, s1, s2, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
