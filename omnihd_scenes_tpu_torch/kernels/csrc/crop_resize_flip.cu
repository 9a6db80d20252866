// The crop-resize-flip training augmentation for Hopper, sm_90a: each f32
// camera image of a batch (N, H, W, 3) cropped, resized to one output
// size with OpenCV's INTER_LINEAR and flipped horizontally on its flag, in
// one launch.  No TPU kernel is replaced: the JAX package runs
// cv2.resize on its host (omnihd_scenes_tpu/data/augmentation.py:193-243
// crop_resize_flip_images).  kernels/crop_resize_flip.py holds the wrapper
// and the plain version (rectify.resize_f32_plain of the crop, then the
// flip).
//
// Arithmetic, as rectify.cu's f32 resize: per axis the source coordinate
// (d + 0.5) * scale - 0.5 and its fraction in f64, the fraction rounded to
// f32 once; a tap left of 0 or at the crop's last pixel is clamped there
// with weight 0 (replicated borders); horizontal then vertical
// fma(b - a, f, a) rounded once.  The plain version's _lerp rounds the
// fused multiply-add exactly, so the two agree bit for bit.  A crop of the
// output's size is copied (cv2.resize's copy).  The flip reads output
// column x from resized column ow - 1 - x.
//
// Bound: bytes (each crop read once, the output written once; ~20 f32
// operations an output value).  Design: one thread an output pixel, the
// image on gridDim.y; the taps' f64 arithmetic is redone per pixel (a few
// operations against 12 bytes stored), the four source pixels come
// through L1 (neighbouring threads share most of them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Tap {
  int s0, s1;
  float f;
};

__device__ __forceinline__ Tap axis_tap(int d, double scale, int n_src) {
  const double c =
      __dadd_rn(__dmul_rn(__dadd_rn(static_cast<double>(d), 0.5), scale),
                -0.5);
  const double s = floor(c);
  float f = __double2float_rn(__dsub_rn(c, s));
  int si = static_cast<int>(s);
  if (si < 0 || si >= n_src - 1) f = 0.f;
  si = min(max(si, 0), n_src - 1);
  return Tap{si, min(si + 1, n_src - 1), f};
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(__fsub_rn(b, a), f, a);
}

// desc: per image (y0, x0, crop_h, crop_w, flip, resize, the bits of the
// f64 scale_y, scale_x).
__global__ void __launch_bounds__(kThreads)
crop_resize_flip_kernel(const float* __restrict__ imgs, int h, int w,
                        const long long* __restrict__ desc, int oh, int ow,
                        float* __restrict__ out) {
  const int img = blockIdx.y;
  const long long px = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (px >= static_cast<long long>(oh) * ow) return;
  const int y = static_cast<int>(px / ow);
  const int x = static_cast<int>(px - static_cast<long long>(y) * ow);
  const long long* d = desc + img * 8;
  const int y0 = static_cast<int>(d[0]), x0 = static_cast<int>(d[1]);
  const int ch = static_cast<int>(d[2]), cw = static_cast<int>(d[3]);
  const bool flip = d[4] != 0, resize = d[5] != 0;
  const float* src = imgs + static_cast<long long>(img) * h * w * 3;
  float o[3];
  if (!resize) {
    const float* p = src + (static_cast<long long>(y0 + y) * w + x0 + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = p[c];
  } else {
    const Tap ty = axis_tap(y, __longlong_as_double(d[6]), ch);
    const Tap tx = axis_tap(x, __longlong_as_double(d[7]), cw);
    const float* r0 = src + static_cast<long long>(y0 + ty.s0) * w * 3;
    const float* r1 = src + static_cast<long long>(y0 + ty.s1) * w * 3;
    const int c0 = (x0 + tx.s0) * 3, c1 = (x0 + tx.s1) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float h0 = lerp(__ldg(r0 + c0 + c), __ldg(r0 + c1 + c), tx.f);
      const float h1 = lerp(__ldg(r1 + c0 + c), __ldg(r1 + c1 + c), tx.f);
      o[c] = lerp(h0, h1, ty.f);
    }
  }
  float* dst = out + ((static_cast<long long>(img) * oh + y) * ow +
                      (flip ? ow - 1 - x : x)) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = o[c];
}

}  // namespace

// One launch over n_img images: imgs (n_img, h, w, 3) f32 and out (n_img,
// oh, ow, 3) f32 on the card; desc (n_img, 8) int64 on the card (above).
// Returns a cudaError_t (0 on success).
extern "C" int crop_resize_flip_launch(const void* imgs, int n_img, int h,
                                       int w, const void* desc, int oh, int ow,
                                       void* out, void* stream) {
  const long long n_px = static_cast<long long>(oh) * ow;
  if (n_img <= 0 || n_px <= 0) return 0;
  if (n_img > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_px + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_img));
  crop_resize_flip_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), h, w,
      static_cast<const long long*>(desc), oh, ow, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
