// Camera image rectification for Hopper, sm_90a: one bilinear resampler
// over a batch of HWC images, the card's stand-in for the OpenCV chain of
// the JAX package's camera loader (omnihd_scenes_tpu/data/
// image_loading.py:load_camera_data: cv2.remap, cv2.resize, normalise,
// cv2.resize, pad).  No TPU kernel is replaced: JAX runs the chain on the
// host.  kernels/rectify.py holds the plain PyTorch version of each pass
// and says what each computes; this file computes the same, op for op:
//
//   kRemap     u8 -> u8: per-pixel map in 1/32 px, OpenCV's 15-bit
//              integer weights, taps outside the image read 0 (cv2.remap
//              BORDER_CONSTANT; not host_ops.cpp:remap_bilinear_u8, which
//              zeroes a pixel with any tap outside);
//   kResizeU8  u8 -> u8: affine map (d + 0.5) * scale - 0.5; mode 1 is
//              the exact 2x downscale, (a + b + c + d + 2) >> 2, mode 0
//              11-bit fixed-point bilinear;
//   kNormalize u8 -> f32: BGR -> RGB and (x - mean) / std on every tap,
//              then fma(b - a, f, a) horizontally and vertically (mode 1:
//              same size, a copy), zero outside the resized image.
//
// Bound: bytes (u8 in once, the output once) over the memory rate; a few
// integer or f32 operations a byte.  Design: one thread per output pixel
// and its three channels, blockIdx.y the image; each image's pointers,
// sizes and scales come from a descriptor table the wrapper uploads, so
// one launch covers images of different sizes (the six cameras of every
// sample of a batch).  Every f32 / f64 operation that a contraction could
// change is an explicit __*_rn intrinsic, so nvcc fuses nothing the plain
// version rounds twice.  The taps are read through the L1 cache; a tiled
// version that stages source rows in shared memory is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDescWords = 12;
enum Kind { kRemap = 0, kResizeU8 = 1, kNormalize = 2, kYcbcr = 3 };
enum Chroma { k444 = 0, k422 = 1, k420 = 2 };

struct Norm {
  float mean[3];
  float std[3];
  int to_rgb;
};

// One image of a launch, as kernels/rectify.py packs it: src pointer,
// src h, w, dst pointer, dst h, w (the whole written extent), the resized
// image's h, w inside it, map pointer, mode, then the f64 scales y, x as
// their bit patterns.  kYcbcr: src is the Y plane, map the Cb plane, the
// word of scale y the Cr plane's pointer, mode the chroma sampling.
struct Desc {
  const uint8_t* src;
  int src_h, src_w;
  void* dst;
  int dst_h, dst_w, img_h, img_w;
  const int32_t* map;
  int mode;
  double sy, sx;
};

__device__ __forceinline__ Desc load_desc(const long long* d) {
  Desc o;
  o.src = reinterpret_cast<const uint8_t*>(d[0]);
  o.src_h = static_cast<int>(d[1]);
  o.src_w = static_cast<int>(d[2]);
  o.dst = reinterpret_cast<void*>(d[3]);
  o.dst_h = static_cast<int>(d[4]);
  o.dst_w = static_cast<int>(d[5]);
  o.img_h = static_cast<int>(d[6]);
  o.img_w = static_cast<int>(d[7]);
  o.map = reinterpret_cast<const int32_t*>(d[8]);
  o.mode = static_cast<int>(d[9]);
  o.sy = __longlong_as_double(d[10]);
  o.sx = __longlong_as_double(d[11]);
  return o;
}

struct Tap {
  int s0, s1;
  float f;
};

// OpenCV's linear taps along one axis (rectify.py:_axis_taps): the source
// coordinate and its fraction in f64, the fraction rounded to f32 once; a
// tap left of 0 or at the last pixel is clamped there with weight 0.
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

__device__ __forceinline__ const uint8_t* pixel(const Desc& d, int y, int x) {
  return d.src + (static_cast<long long>(y) * d.src_w + x) * 3;
}

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// libjpeg's fancy upsampling of chroma plane c (ch, cw) at pixel (y, x).
__device__ __forceinline__ int chroma_at(const uint8_t* c, int ch, int cw,
                                         int mode, int y, int x) {
  if (mode == k444) return c[static_cast<long long>(y) * cw + x];
  const int col = x >> 1, odd = x & 1;
  const int side = odd ? min(col + 1, cw - 1) : max(col - 1, 0);
  if (mode == k422) {
    const uint8_t* row = c + static_cast<long long>(y) * cw;
    return (row[col] * 3 + row[side] + (odd ? 2 : 1)) >> 2;
  }
  const int r = y >> 1;
  const int rf = (y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
  const uint8_t* near = c + static_cast<long long>(r) * cw;
  const uint8_t* far = c + static_cast<long long>(rf) * cw;
  const int cs = near[col] * 3 + far[col];
  const int cs_side = near[side] * 3 + far[side];
  return (cs * 3 + cs_side + (odd ? 7 : 8)) >> 4;
}

__device__ void ycbcr_pixel(const Desc& d, const long long* raw, int y,
                            int x, long long p) {
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(d.map);
  const uint8_t* cr = reinterpret_cast<const uint8_t*>(raw[10]);
  const int ch = d.mode == k420 ? (d.src_h + 1) >> 1 : d.src_h;
  const int cw = d.mode == k444 ? d.src_w : (d.src_w + 1) >> 1;
  const int lum = d.src[p];
  const int xb = chroma_at(cb, ch, cw, d.mode, y, x) - 128;
  const int xr = chroma_at(cr, ch, cw, d.mode, y, x) - 128;
  uint8_t* out = static_cast<uint8_t*>(d.dst) + p * 3;
  out[0] = clamp_u8(lum + ((116130 * xb + 32768) >> 16));
  out[1] = clamp_u8(lum + ((-22554 * xb + 32768 - 46802 * xr) >> 16));
  out[2] = clamp_u8(lum + ((91881 * xr + 32768) >> 16));
}

__device__ void remap_pixel(const Desc& d, int y, int x, long long p) {
  const int iu = d.map[2 * p], iv = d.map[2 * p + 1];
  const int x0 = iu >> 5, y0 = iv >> 5, fx = iu & 31, fy = iv & 31;
  int acc[3] = {0, 0, 0};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int ys = y0 + dy, xs = x0 + dx;
      if (ys < 0 || ys >= d.src_h || xs < 0 || xs >= d.src_w) continue;
      const int w = (dy ? fy : 32 - fy) * (dx ? fx : 32 - fx) * 32;
      const uint8_t* q = pixel(d, ys, xs);
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] += static_cast<int>(q[c]) * w;
    }
  }
  uint8_t* out = static_cast<uint8_t*>(d.dst) + p * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = clamp_u8((acc[c] + (1 << 14)) >> 15);
}

__device__ void resize_u8_pixel(const Desc& d, int y, int x, long long p) {
  uint8_t* out = static_cast<uint8_t*>(d.dst) + p * 3;
  if (d.mode == 1) {                       // exact 2x: OpenCV's area-fast
    const uint8_t* r0 = pixel(d, 2 * y, 2 * x);
    const uint8_t* r1 = r0 + static_cast<long long>(d.src_w) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = static_cast<uint8_t>(
          (r0[c] + r0[3 + c] + r1[c] + r1[3 + c] + 2) >> 2);
    return;
  }
  const Tap ty = axis_tap(y, d.sy, d.src_h), tx = axis_tap(x, d.sx, d.src_w);
  const int ax1 = __float2int_rn(__fmul_rn(tx.f, 2048.f)), ax0 = 2048 - ax1;
  const int by1 = __float2int_rn(__fmul_rn(ty.f, 2048.f)), by0 = 2048 - by1;
  const uint8_t *a = pixel(d, ty.s0, tx.s0), *b = pixel(d, ty.s0, tx.s1);
  const uint8_t *e = pixel(d, ty.s1, tx.s0), *g = pixel(d, ty.s1, tx.s1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int h0 = a[c] * ax0 + b[c] * ax1, h1 = e[c] * ax0 + g[c] * ax1;
    out[c] = clamp_u8((h0 * by0 + h1 * by1 + (1 << 21)) >> 22);
  }
}

__device__ __forceinline__ float normalized(const uint8_t* q, int c,
                                            const Norm& n) {
  const int sc = n.to_rgb ? 2 - c : c;
  return __fdiv_rn(__fsub_rn(static_cast<float>(q[sc]), n.mean[c]),
                   n.std[c]);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(__fsub_rn(b, a), f, a);
}

__device__ void normalize_pixel(const Desc& d, int y, int x, long long p,
                                const Norm& n) {
  float* out = static_cast<float*>(d.dst) + p * 3;
  if (y >= d.img_h || x >= d.img_w) {
    out[0] = out[1] = out[2] = 0.f;
    return;
  }
  if (d.mode == 1) {                       // same size: no resize
    const uint8_t* q = pixel(d, y, x);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = normalized(q, c, n);
    return;
  }
  const Tap ty = axis_tap(y, d.sy, d.src_h), tx = axis_tap(x, d.sx, d.src_w);
  const uint8_t *a = pixel(d, ty.s0, tx.s0), *b = pixel(d, ty.s0, tx.s1);
  const uint8_t *e = pixel(d, ty.s1, tx.s0), *g = pixel(d, ty.s1, tx.s1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float h0 = lerp(normalized(a, c, n), normalized(b, c, n), tx.f);
    const float h1 = lerp(normalized(e, c, n), normalized(g, c, n), tx.f);
    out[c] = lerp(h0, h1, ty.f);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    rectify_kernel(const long long* __restrict__ desc, Norm n) {
  const long long* raw = desc + kDescWords * blockIdx.y;
  const Desc d = load_desc(raw);
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= static_cast<long long>(d.dst_h) * d.dst_w) return;
  const int y = static_cast<int>(p / d.dst_w);
  const int x = static_cast<int>(p - static_cast<long long>(y) * d.dst_w);
  if (K == kYcbcr)
    ycbcr_pixel(d, raw, y, x, p);
  else if (K == kRemap)
    remap_pixel(d, y, x, p);
  else if (K == kResizeU8)
    resize_u8_pixel(d, y, x, p);
  else
    normalize_pixel(d, y, x, p, n);
}

}  // namespace

// One pass over n_img images: desc (n_img, 12) int64 on the card,
// max_pixels the largest dst_h * dst_w among them; mean / std / to_rgb
// are read by kNormalize only.  Returns a cudaError_t (0 on success).
extern "C" int rectify_launch(int kind, const long long* desc, int n_img,
                              long long max_pixels, float m0, float m1,
                              float m2, float s0, float s1, float s2,
                              int to_rgb, void* stream) {
  if (n_img <= 0 || max_pixels <= 0) return 0;
  const long long blocks = (max_pixels + kThreads - 1) / kThreads;
  if (n_img > 65535 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_img));
  const Norm n{{m0, m1, m2}, {s0, s1, s2}, to_rgb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRemap:
      rectify_kernel<kRemap><<<grid, kThreads, 0, s>>>(desc, n);
      break;
    case kResizeU8:
      rectify_kernel<kResizeU8><<<grid, kThreads, 0, s>>>(desc, n);
      break;
    case kNormalize:
      rectify_kernel<kNormalize><<<grid, kThreads, 0, s>>>(desc, n);
      break;
    case kYcbcr:
      rectify_kernel<kYcbcr><<<grid, kThreads, 0, s>>>(desc, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
