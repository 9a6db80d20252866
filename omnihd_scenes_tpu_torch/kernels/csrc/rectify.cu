// Camera image rectification for Hopper, sm_90a: from a decoded JPEG's
// Y / Cb / Cr planes to the model's padded f32 image, for every camera of
// a batch in one launch.  The card's stand-in for the end of libjpeg's
// decode and the OpenCV chain of the JAX package's camera loader
// (omnihd_scenes_tpu/data/image_loading.py:load_camera_data: cv2.imread,
// cv2.remap, cv2.resize, normalise, cv2.resize, pad).  No TPU kernel is
// replaced: JAX runs the chain on the host.  kernels/rectify.py holds the
// plain PyTorch version of each step and says what each computes; this
// file computes the same, op for op, at every pixel it needs:
//
//   I  the decoded BGR image: libjpeg's fancy chroma upsampling (jdsample.c
//      h2v1 / h2v2, edges replicated) and YCbCr -> BGR tables (jdcolor.c);
//   U  the undistorted image (when the camera has a map): the map's
//      1/32-px coordinates, OpenCV's 15-bit integer bilinear weights, taps
//      outside the image read 0 (cv2.remap BORDER_CONSTANT);
//   S  the u8 image at its downscaled size (front and back cameras): the
//      exact 2x area mean (a + b + c + d + 2) >> 2, or 11-bit fixed-point
//      bilinear at another factor;
//   out BGR -> RGB and (x - mean) / std on each tap of S, then
//      fma(b - a, f, a) horizontally and vertically on f32 (or a copy at
//      the same size), zero outside the resized image (the pad).
//
// Every intermediate before the f32 resize is an integer, and every f32 /
// f64 operation is an explicit __*_rn intrinsic (nvcc contracts nothing
// else), so the output equals the plain version's bit for bit.
//
// Bound: bytes (the planes and each distinct map read once, the f32
// output written once) over the memory rate.  Design: one launch, nothing
// intermediate in global memory.  A CTA (8 warps) owns a tile of 32 output
// columns by 8, 16 or 32 rows (as many as keep its footprint in shared
// memory), and works in three steps:
//   1. it copies what the tile reads into shared memory with asynchronous
//      8-byte copies: the Y samples of the box of I that the tile's taps
//      reach, the chroma samples their upsampling reads, and the packed
//      map entries of the U pixels the tile reads.  The box comes from the
//      calibration's footprint table (footprint_kernel, run once per map
//      and geometry and kept with the map, kernels/rectify.py:DeviceMap),
//      so the copies start at once;
//   2. it decodes the box, 2x2 pixels a thread at a time, to packed BGR
//      (the quad's chroma from one 3x3 patch of each plane);
//   3. each thread computes one output pixel of each of its rows from the
//      stage (remap with B and R side by side in one word, halving,
//      normalise through a 256-entry table per channel, the f32 resize on
//      the tile's tap table), and each warp stores its 96 floats a row as
//      three coalesced 128-byte rows of the HWC output.
// A tile whose footprint does not fit reads the planes and the map through
// L1 instead (undistorted_px), in the same kernel.  The canvas around the
// resized image is zeroed by 32 x 32 tiles that do nothing else.  Images
// of one geometry and map take turns tile by tile, so the CTAs that run
// together read one region of the map (on an H100, 3-4 % faster than
// laying the tiles out image by image, with one map or six per-camera
// maps).  Each image's pointers, sizes and scales come from a descriptor
// table the wrapper uploads, so one launch covers images of different
// sizes and samplings.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kMaxTileRows = 32;            // 4 rows of 8 warps' rows
constexpr int kDescWords = 30;
// The stage (dynamic shared memory): the decoded box, packed BGR; the
// tile's map entries, packed; the Y box and the two chroma boxes.
constexpr int kStagePixels = 4800;
constexpr int kMapEntries = 4352;
constexpr int kRawY = 6144;
constexpr int kRawC = 2560;
constexpr int kDynamicSmem =
    (kStagePixels + kMapEntries) * 4 + kRawY + 2 * kRawC;
constexpr int kFarFootprint = -(1 << 30);
enum Chroma { k444 = 0, k422 = 1, k420 = 2 };
enum U8Kind { kU8Same = 0, kU8Area2 = 1, kU8Bilinear = 2 };

// One image, as kernels/rectify.py packs it (int64 words): the Y plane
// and its row pitch, the Cb and Cr planes and their shared pitch, the
// image h, w, the chroma planes' h, w, the chroma mode; the undistortion
// map (h, w, 2) int32 in 1/32 px, or 0; the u8 size, its kind and f64
// scales; the resized size, whether it resizes, its f64 scales; the
// output image's pointer (target_h, target_w, 3) f32.
struct Img {
  const uint8_t* y;
  long long ypitch;
  const uint8_t* cb;
  const uint8_t* cr;
  long long cpitch;
  int h, w, ch, cw, mode;
  const int32_t* map;
  int u8h, u8w, u8kind;
  double usy, usx;
  int oh, ow, resize;
  double fsy, fsx;
  float* dst;
};

__device__ __forceinline__ Img load_img(const long long* d) {
  Img m;
  m.y = reinterpret_cast<const uint8_t*>(d[0]);
  m.ypitch = d[1];
  m.cb = reinterpret_cast<const uint8_t*>(d[2]);
  m.cr = reinterpret_cast<const uint8_t*>(d[3]);
  m.cpitch = d[4];
  m.h = static_cast<int>(d[5]);
  m.w = static_cast<int>(d[6]);
  m.ch = static_cast<int>(d[7]);
  m.cw = static_cast<int>(d[8]);
  m.mode = static_cast<int>(d[9]);
  m.map = reinterpret_cast<const int32_t*>(d[10]);
  m.u8h = static_cast<int>(d[11]);
  m.u8w = static_cast<int>(d[12]);
  m.u8kind = static_cast<int>(d[13]);
  m.usy = __longlong_as_double(d[14]);
  m.usx = __longlong_as_double(d[15]);
  m.oh = static_cast<int>(d[16]);
  m.ow = static_cast<int>(d[17]);
  m.resize = static_cast<int>(d[18]);
  m.fsy = __longlong_as_double(d[19]);
  m.fsx = __longlong_as_double(d[20]);
  m.dst = reinterpret_cast<float*>(d[21]);
  return m;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clamp_u8(int v) { return clampi(v, 0, 255); }

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
  si = clampi(si, 0, n_src - 1);
  return Tap{si, min(si + 1, n_src - 1), f};
}

// jdcolor.c's tables: (B, G, R) of one Y and centred Cb, Cr.
__device__ __forceinline__ void ycc_bgr(int lum, int xb, int xr, int o[3]) {
  o[0] = clamp_u8(lum + ((116130 * xb + 32768) >> 16));
  o[1] = clamp_u8(lum + ((-22554 * xb + 32768 - 46802 * xr) >> 16));
  o[2] = clamp_u8(lum + ((91881 * xr + 32768) >> 16));
}

__device__ __forceinline__ int plane_at(const uint8_t* p, long long pitch,
                                        int r, int c) {
  return __ldg(p + r * pitch + c);
}

// Fancy-upsampled chroma of plane c at one pixel (y, x) of the image.
__device__ __forceinline__ int chroma_at(const Img& m, const uint8_t* c,
                                         int y, int x) {
  if (m.mode == k444) return plane_at(c, m.cpitch, y, x);
  const int col = x >> 1, odd = x & 1;
  const int side = odd ? min(col + 1, m.cw - 1) : max(col - 1, 0);
  if (m.mode == k422)
    return (plane_at(c, m.cpitch, y, col) * 3 +
            plane_at(c, m.cpitch, y, side) + 1 + odd) >> 2;
  const int r = y >> 1;
  const int rf = (y & 1) ? min(r + 1, m.ch - 1) : max(r - 1, 0);
  const int cs = plane_at(c, m.cpitch, r, col) * 3 +
                 plane_at(c, m.cpitch, rf, col);
  const int cs_side = plane_at(c, m.cpitch, r, side) * 3 +
                      plane_at(c, m.cpitch, rf, side);
  return (cs * 3 + cs_side + 8 - odd) >> 4;
}

// I at one pixel inside the image.
__device__ __forceinline__ void decoded_px(const Img& m, int y, int x,
                                           int o[3]) {
  ycc_bgr(plane_at(m.y, m.ypitch, y, x), chroma_at(m, m.cb, y, x) - 128,
          chroma_at(m, m.cr, y, x) - 128, o);
}

// Fancy-upsampled chroma of plane c at the 2x2 pixels (y0 + i, x0 + j),
// i, j in {0, 1}, from one 3x3 patch of the plane (its rows and columns
// clamped into the plane): every upsampled value reads its nearer sample
// and the neighbour on each subsampled axis, and the quad's lie in the
// patch.  Pixels outside the image get some value (their taps weigh 0).
// (Decoding each tap through decoded_px instead is simpler, but it costs
// the main kernel registers: 9 % slower on an H100 for the b4 batch of
// PERF.md.)
__device__ __forceinline__ void chroma_quad(const Img& m, const uint8_t* c,
                                            int y0, int x0, int q[2][2]) {
  const bool yo = y0 & 1, xo = x0 & 1;
  int rows[3], cols[3];
  const int rb = m.mode == k420 ? (y0 >> 1) - 1 : y0;
  const int cb = m.mode == k444 ? x0 : (x0 >> 1) - 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rows[k] = clampi(rb + k, 0, m.ch - 1);
    cols[k] = clampi(cb + k, 0, m.cw - 1);
  }
  int v[2][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p0 = plane_at(c, m.cpitch, rows[0], cols[k]);
    const int p1 = plane_at(c, m.cpitch, rows[1], cols[k]);
    if (m.mode == k420) {
      const int p2 = plane_at(c, m.cpitch, rows[2], cols[k]);
      // y0 even: rows (1, 0) then (1, 2); y0 odd: (1, 2) then (2, 1).
      v[0][k] = 3 * p1 + (yo ? p2 : p0);
      v[1][k] = yo ? 3 * p2 + p1 : 3 * p1 + p2;
    } else {
      v[0][k] = p0;
      v[1][k] = p1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (m.mode == k444) {
      q[i][0] = v[i][0];
      q[i][1] = v[i][1];
    } else {
      // x0 even: (near 1, side 0, even), (1, 2, odd); x0 odd: (1, 2, odd),
      // (2, 1, even).
      const int n0 = v[i][1], s0 = xo ? v[i][2] : v[i][0];
      const int n1 = xo ? v[i][2] : v[i][1], s1 = xo ? v[i][1] : v[i][2];
      const int odd0 = xo, odd1 = !xo;
      if (m.mode == k422) {
        q[i][0] = (3 * n0 + s0 + 1 + odd0) >> 2;
        q[i][1] = (3 * n1 + s1 + 1 + odd1) >> 2;
      } else {
        q[i][0] = (3 * n0 + s0 + 8 - odd0) >> 4;
        q[i][1] = (3 * n1 + s1 + 8 - odd1) >> 4;
      }
    }
  }
}

// U at (uy, ux): cv2.remap of I on the map entry there, every tap
// computed from the planes (the path of a tile whose footprint does not
// fit the stage).  It reads the image from its descriptor words (`d`, in
// shared memory), so the caller's copy stays in registers.
__device__ __noinline__ void undistorted_px(const long long* d, int uy,
                                            int ux, int o[3]) {
  const Img m = load_img(d);
  if (!m.map) {
    decoded_px(m, uy, ux, o);
    return;
  }
  const int2 e = __ldg(reinterpret_cast<const int2*>(m.map) +
                       static_cast<long long>(uy) * m.w + ux);
  const int x0 = e.x >> 5, y0 = e.y >> 5, fx = e.x & 31, fy = e.y & 31;
  int acc[3] = {0, 0, 0};
  if (x0 >= -1 && x0 < m.w && y0 >= -1 && y0 < m.h) {
    int cbq[2][2], crq[2][2];
    chroma_quad(m, m.cb, y0, x0, cbq);
    chroma_quad(m, m.cr, y0, x0, crq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ys = y0 + i, xs = x0 + j;
        if (ys < 0 || ys >= m.h || xs < 0 || xs >= m.w) continue;
        int px[3];
        ycc_bgr(plane_at(m.y, m.ypitch, ys, xs), cbq[i][j] - 128,
                crq[i][j] - 128, px);
        const int wgt = (i ? fy : 32 - fy) * (j ? fx : 32 - fx) * 32;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] += px[c] * wgt;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = clamp_u8((acc[c] + (1 << 14)) >> 15);
}

struct DirectU {
  const long long* d;
  __device__ __forceinline__ void operator()(const Img&, int uy, int ux,
                                             int o[3]) const {
    int t[3];
    undistorted_px(d, uy, ux, t);
    o[0] = t[0];
    o[1] = t[1];
    o[2] = t[2];
  }
};

// S at (sy, sx): U itself, its exact 2x area mean, or OpenCV's 11-bit
// fixed-point bilinear resize of it.
template <class U>
__device__ __forceinline__ void staged_px(const Img& m, const U& u, int sy,
                                          int sx, int o[3]) {
  if (m.u8kind == kU8Same) {
    u(m, sy, sx, o);
    return;
  }
  if (m.u8kind == kU8Area2) {
    int s[3] = {2, 2, 2};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int t[3];
      u(m, 2 * sy + (k >> 1), 2 * sx + (k & 1), t);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] += t[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = s[c] >> 2;
    return;
  }
  const Tap ty = axis_tap(sy, m.usy, m.h), tx = axis_tap(sx, m.usx, m.w);
  const int ax1 = __float2int_rn(__fmul_rn(tx.f, 2048.f)), ax0 = 2048 - ax1;
  const int by1 = __float2int_rn(__fmul_rn(ty.f, 2048.f)), by0 = 2048 - by1;
  int a[3], b[3], e[3], g[3];
  u(m, ty.s0, tx.s0, a);
  u(m, ty.s0, tx.s1, b);
  u(m, ty.s1, tx.s0, e);
  u(m, ty.s1, tx.s1, g);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int h0 = a[c] * ax0 + b[c] * ax1, h1 = e[c] * ax0 + g[c] * ax1;
    o[c] = clamp_u8((h0 * by0 + h1 * by1 + (1 << 21)) >> 22);
  }
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fmaf_rn(__fsub_rn(b, a), f, a);
}

// Normalised channels of a u8 BGR pixel: lut[c][v] is (v - mean[c]) /
// std[c] in f32, each step rounded (the wrapper computes the table);
// output channel 0 reads R when to_rgb.
__device__ __forceinline__ void normalized(const int q[3], bool to_rgb,
                                           const float (*lut)[256],
                                           float o[3]) {
  o[0] = lut[0][to_rgb ? q[2] : q[0]];
  o[1] = lut[1][q[1]];
  o[2] = lut[2][to_rgb ? q[0] : q[2]];
}

// The output pixel at taps (ty, tx) of the f32 resize (a tap's s0 is the
// pixel itself when the image is not resized).
template <class U>
__device__ __forceinline__ void output_px(const Img& m, const U& u,
                                          const Tap& ty, const Tap& tx,
                                          const float (*lut)[256],
                                          bool to_rgb, float o[3]) {
  if (!m.resize) {
    int q[3];
    staged_px(m, u, ty.s0, tx.s0, q);
    normalized(q, to_rgb, lut, o);
    return;
  }
  float h[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int sy = i ? ty.s1 : ty.s0;
    int a[3], b[3];
    float na[3], nb[3];
    staged_px(m, u, sy, tx.s0, a);
    staged_px(m, u, sy, tx.s1, b);
    normalized(a, to_rgb, lut, na);
    normalized(b, to_rgb, lut, nb);
#pragma unroll
    for (int c = 0; c < 3; ++c) h[i][c] = lerp(na[c], nb[c], tx.f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = lerp(h[0][c], h[1][c], ty.f);
}

// The rows (or columns) [lo, hi] of the u8 image S, then of U, that the
// output rows (or columns) [lo, hi] read.
__device__ __forceinline__ void source_span(const Img& m, bool rows, int& lo,
                                            int& hi) {
  if (m.resize) {
    const double f = rows ? m.fsy : m.fsx;
    const int n = rows ? m.u8h : m.u8w;
    const int a = axis_tap(lo, f, n).s0, b = axis_tap(hi, f, n).s1;
    lo = a;
    hi = b;
  }
  if (m.u8kind == kU8Area2) {
    lo = 2 * lo;
    hi = 2 * hi + 1;
  } else if (m.u8kind == kU8Bilinear) {
    const double f = rows ? m.usy : m.usx;
    const int n = rows ? m.h : m.w;
    const int a = axis_tap(lo, f, n).s0, b = axis_tap(hi, f, n).s1;
    lo = a;
    hi = b;
  }
}

// A rows x cols rectangle walked by the CTA's threads, element
// tid, tid + 256, ... in row-major order, without a division a step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int tid, int cols_)
      : r(tid / cols_), c(tid % cols_), dr(kThreads / cols_),
        dc(kThreads % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// A plane's samples over a box, in shared memory: rows [r0, r0 + rows),
// columns [c0, c0 + stride); read with clamped indices.
struct RawPlane {
  uint8_t* p;
  int r0, c0, stride;
  __device__ __forceinline__ int at(int r, int c) const {
    return p[(r - r0) * stride + (c - c0)];
  }
};

// An asynchronous copy of B (4, 8 or 16) bytes from global to shared
// memory.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  static_assert(B == 4 || B == 8 || B == 16, "cp.async copies 4, 8, 16");
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(B));
#else
  memcpy(dst, src, B);
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Copy rows [r0, r1] and columns [c0, c1] of a plane into shared memory,
// in asynchronous 16- or 8-byte copies where the plane allows them
// (`align`: 16, 8 or 1) and the widened rows fit `cap` bytes, else in
// byte loads.  Returns the copy's layout, with a null pointer when it does
// not fit.
__device__ __forceinline__ RawPlane copy_box(uint8_t* dst, int cap,
                                             const uint8_t* src,
                                             long long pitch, int align,
                                             int r0, int r1, int c0, int c1,
                                             int tid) {
  const int rows = r1 - r0 + 1;
  for (; align >= 8; align >>= 1) {
    const int a0 = c0 & -align, stride = ((c1 + align) & -align) - a0;
    if (rows * stride > cap) continue;
    const int ws = stride / align;
    Walk k(tid, ws);
    for (int i = tid; i < rows * ws; i += kThreads, k.next()) {
      uint8_t* d = dst + align * i;
      const uint8_t* g = src + (r0 + k.r) * pitch + a0 + align * k.c;
      if (align == 16)
        copy_async<16>(d, g);
      else
        copy_async<8>(d, g);
    }
    return RawPlane{dst, r0, a0, stride};
  }
  const int stride = c1 - c0 + 1;
  if (rows * stride > cap) return RawPlane{nullptr, r0, c0, stride};
  Walk k(tid, stride);
#pragma unroll 4
  for (int i = tid; i < rows * stride; i += kThreads, k.next())
    dst[i] = __ldg(src + (r0 + k.r) * pitch + c0 + k.c);
  return RawPlane{dst, r0, c0, stride};
}

// The 2x2 decoded pixels (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)
// at even (y, x), packed B | G << 8 | R << 16, from the staged planes: the
// four's chroma through one 3x3 patch of each plane (each upsampled value
// reads its nearer sample and the neighbours on the subsampled axes),
// indices clamped into the planes (a pixel past the image's last row or
// column gets some value; no tap reads it).
__device__ __forceinline__ void bgr_quad(const Img& m, const RawPlane& py,
                                         const RawPlane& pb,
                                         const RawPlane& pr, int y, int x,
                                         unsigned q[2][2]) {
  int rows[3], cols[3];
  const int rb = m.mode == k420 ? (y >> 1) - 1 : y;
  const int cb = m.mode == k444 ? x : (x >> 1) - 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rows[k] = clampi(rb + k, 0, m.ch - 1);
    cols[k] = clampi(cb + k, 0, m.cw - 1);
  }
  int up[2][2][2];                           // [plane][i][j]
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const RawPlane& c = p ? pr : pb;
    int v[2][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k == 2 && m.mode == k444) break;   // no third column read
      const int p0 = c.at(rows[0], cols[k]), p1 = c.at(rows[1], cols[k]);
      if (m.mode == k420) {
        const int p2 = c.at(rows[2], cols[k]);
        v[0][k] = 3 * p1 + p0;
        v[1][k] = 3 * p1 + p2;
      } else {
        v[0][k] = p0;
        v[1][k] = p1;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (m.mode == k444) {
        up[p][i][0] = v[i][0];
        up[p][i][1] = v[i][1];
      } else if (m.mode == k422) {
        up[p][i][0] = (3 * v[i][1] + v[i][0] + 1) >> 2;
        up[p][i][1] = (3 * v[i][1] + v[i][2] + 2) >> 2;
      } else {
        up[p][i][0] = (3 * v[i][1] + v[i][0] + 8) >> 4;
        up[p][i][1] = (3 * v[i][1] + v[i][2] + 7) >> 4;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int o[3];
      ycc_bgr(py.at(min(y + i, m.h - 1), min(x + j, m.w - 1)),
              up[0][i][j] - 128, up[1][i][j] - 128, o);
      q[i][j] = o[0] | o[1] << 8 | o[2] << 16;
    }
  }
}

// U from the tile's stage: I packed as B | G << 8 | R << 16 over the box
// [y0, y0 + h) x [x0, x0 + w), which holds every tap inside the image,
// and each U pixel's map entry, packed as pack_map_kernel packs it, over
// the U rectangle [uy0, ..) x [ux0, ..), uw entries a row.  cv2.remap's sum
// acc = sum v wy wx 32 is computed as S = sum_i wy_i (sum_j wx_j v_ij),
// the rows with B and R side by side in one word; (acc + 2^14) >> 15 is
// (S + 2^9) >> 10, at most 255.
struct StagedU {
  const unsigned* st;
  const unsigned* mp;
  int y0, x0, w, uy0, ux0, uw;
  __device__ __forceinline__ unsigned at(int y, int x) const {
    return st[(y - y0) * w + (x - x0)];
  }
  __device__ __forceinline__ void operator()(const Img& m, int uy, int ux,
                                             int o[3]) const {
    if (!m.map) {
      const unsigned v = at(uy, ux);
      o[0] = v & 255;
      o[1] = (v >> 8) & 255;
      o[2] = v >> 16;
      return;
    }
    const unsigned e = mp[(uy - uy0) * uw + (ux - ux0)];
    const int x0 = ux + (static_cast<int>(e << 21) >> 21);
    const int y0 = uy + (static_cast<int>(e << 10) >> 21);
    const unsigned fx = (e >> 22) & 31, fy = e >> 27;
    unsigned v[2][2];
    if (x0 >= 0 && y0 >= 0 && x0 + 1 < m.w && y0 + 1 < m.h) {
      v[0][0] = at(y0, x0);
      v[0][1] = at(y0, x0 + 1);
      v[1][0] = at(y0 + 1, x0);
      v[1][1] = at(y0 + 1, x0 + 1);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ys = y0 + i, xs = x0 + j;
          v[i][j] = ys < 0 || ys >= m.h || xs < 0 || xs >= m.w
                        ? 0u : at(ys, xs);
        }
      }
    }
    unsigned br[2], g[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      br[i] = (v[i][0] & 0x00FF00FFu) * (32 - fx) +
              (v[i][1] & 0x00FF00FFu) * fx;
      g[i] = ((v[i][0] >> 8) & 255) * (32 - fx) +
             ((v[i][1] >> 8) & 255) * fx;
    }
    const unsigned b = (br[0] & 0xFFFF) * (32 - fy) + (br[1] & 0xFFFF) * fy;
    const unsigned r = (br[0] >> 16) * (32 - fy) + (br[1] >> 16) * fy;
    const unsigned gg = g[0] * (32 - fy) + g[1] * fy;
    o[0] = static_cast<int>((b + 512) >> 10);
    o[1] = static_cast<int>((gg + 512) >> 10);
    o[2] = static_cast<int>((r + 512) >> 10);
  }
};

// A content tile's geometry: its first output row and column, and the U
// rectangle its output pixels read.
struct TileRect {
  int y0, x0, uy0, uy1, ux0, ux1;
};

__device__ __forceinline__ TileRect tile_rect(const Img& m, int t, int rows,
                                              int th, int tw) {
  const int tiles_x = (min(m.ow, tw) + 31) / 32;
  TileRect r;
  r.y0 = (t / tiles_x) * rows;
  r.x0 = (t % tiles_x) * 32;
  r.uy0 = r.y0;
  r.uy1 = min(min(r.y0 + rows, th), m.oh) - 1;
  r.ux0 = r.x0;
  r.ux1 = min(min(r.x0 + 32, tw), m.ow) - 1;
  source_span(m, true, r.uy0, r.uy1);
  source_span(m, false, r.ux0, r.ux1);
  return r;
}

// Zero one 32 x 32 tile of the canvas outside the content tiles: the band
// below them, then the band to their right.
__device__ __forceinline__ void zero_tile(const Img& m, int z, int rows,
                                          int content, int th, int tw,
                                          int warp, int lane) {
  const int tiles_x = (min(m.ow, tw) + 31) / 32;
  const int tiles_y = content / tiles_x;
  const int rc = min(tiles_y * rows, th), cc = min(tiles_x * 32, tw);
  const int below_x = (tw + 31) / 32;
  const int below = ((th - rc + 31) / 32) * below_x;
  int y0, x0, ye;
  if (z < below) {
    y0 = rc + (z / below_x) * 32;
    x0 = (z % below_x) * 32;
    ye = th;
  } else {
    const int right_x = (tw - cc + 31) / 32;
    z -= below;
    y0 = (z / right_x) * 32;
    x0 = cc + (z % right_x) * 32;
    ye = rc;
  }
  const int valid = min(32, tw - x0) * 3;
  for (int y = y0 + warp; y < min(y0 + 32, ye); y += kWarpsPerCta) {
    float* row = m.dst + (static_cast<long long>(y) * tw + x0) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = k * 32 + lane;
      if (i < valid) row[i] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    rectify_kernel(const long long* __restrict__ desc, int n_img,
                   int n_groups, int th, int tw,
                   const float* __restrict__ norm_lut, int to_rgb) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* st = reinterpret_cast<unsigned*>(smem);
  unsigned* mps = st + kStagePixels;
  uint8_t* raw_y = reinterpret_cast<uint8_t*>(mps + kMapEntries);
  uint8_t* raw_c = raw_y + kRawY;
  __shared__ long long sd[kDescWords];
  __shared__ __align__(16) float lut[3][256];
  __shared__ float stage[kWarpsPerCta][96];
  __shared__ Tap taps[2][kMaxTileRows];      // the f32 resize's, rows, cols
  __shared__ int4 info[2];                   // the tile's U rectangle, box
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  // The tile's group (its first launch tile, first image, size): images of
  // one geometry and map take turns tile by tile, so the CTAs that run
  // together read one map region.
  const long long* groups = desc + n_img * kDescWords;
  int lo = 0, hi = n_groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(groups + 4 * mid) <= blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int k = blockIdx.x - static_cast<int>(__ldg(groups + 4 * lo));
  const int size = static_cast<int>(__ldg(groups + 4 * lo + 2));
  const int img = static_cast<int>(__ldg(groups + 4 * lo + 1)) + k % size;
  const int t = k / size;
  if (tid < kDescWords) sd[tid] = desc[img * kDescWords + tid];
  __syncthreads();
  const Img m = load_img(sd);
  const int rows = static_cast<int>(sd[22]) * kWarpsPerCta;   // tile height
  const int content = static_cast<int>(sd[28]);
  if (t >= content) {
    zero_tile(m, t - content, rows, content, th, tw, warp, lane);
    return;
  }
  const int flags = static_cast<int>(sd[23]);
  const unsigned* packed = reinterpret_cast<const unsigned*>(sd[24]);
  const int4* table = reinterpret_cast<const int4*>(sd[25]);
  const int tiles_x = (min(m.ow, tw) + 31) / 32;
  const int y0 = (t / tiles_x) * rows, x0 = (t % tiles_x) * 32;
  // The tile's U rectangle and footprint, the f32 resize's taps of its
  // rows and columns (all from the geometry's tables), and the
  // normalisation table.
  if (tid < 2) info[tid] = __ldg(table + 2 * t + tid);
  if (m.resize && tid >= 32 && tid < 96) {
    const int j = tid & 31;
    const int4 e = tid < 64 ? __ldg(reinterpret_cast<const int4*>(sd[26]) +
                                    y0 + j)
                            : __ldg(reinterpret_cast<const int4*>(sd[27]) +
                                    x0 + j);
    taps[tid >= 64][j] = Tap{e.x, e.y, __int_as_float(e.z)};
  }
  if (tid < 192)
    copy_async<16>(&lut[0][0] + 4 * tid, norm_lut + 4 * tid);
  __syncthreads();
  const int4 ur = info[0], f = info[1];
  const int uy0 = ur.x, uy1 = ur.y, ux0 = ur.z, ux1 = ur.w;
  const int uh = uy1 - uy0 + 1, uw = ux1 - ux0 + 1;
  // The footprint clipped to the image and grown to whole 2x2 quads; the
  // chroma rows and columns its upsampling reads.
  int by0 = max(f.x, 0), by1 = min(f.y + 1, m.h - 1);
  int bx0 = max(f.z, 0), bx1 = min(f.w + 1, m.w - 1);
  by0 &= ~1;
  bx0 &= ~1;
  by1 |= 1;
  bx1 |= 1;
  const int bh = max(by1 - by0 + 1, 0), bw = max(bx1 - bx0 + 1, 0);
  const bool sv = m.mode == k420, sh = m.mode != k444;
  const int cy0 = clampi(sv ? (by0 >> 1) - 1 : by0, 0, m.ch - 1);
  const int cy1 = clampi(sv ? (by1 >> 1) + 1 : by1, 0, m.ch - 1);
  const int cx0 = clampi(sh ? (bx0 >> 1) - 1 : bx0, 0, m.cw - 1);
  const int cx1 = clampi(sh ? (bx1 >> 1) + 1 : bx1, 0, m.cw - 1);
  // The map entries' row stride: whole 16-byte copies where they align.
  const bool wide = ((ux0 | m.w) & 3) == 0 && ux0 + ((uw + 3) & ~3) <= m.w;
  const int mstride = wide ? (uw + 3) & ~3 : uw;
  bool staged = f.z != kFarFootprint && bh * bw <= kStagePixels &&
                (!m.map || uh * mstride <= kMapEntries);
  RawPlane py{}, pb{}, pr{};
  if (staged && bh > 0 && bw > 0) {
    py = copy_box(raw_y, kRawY, m.y, m.ypitch, flags & 255, by0,
                  min(by1, m.h - 1), bx0, min(bx1, m.w - 1), tid);
    pb = copy_box(raw_c, kRawC, m.cb, m.cpitch, flags >> 8, cy0, cy1, cx0,
                  cx1, tid);
    pr = copy_box(raw_c + kRawC, kRawC, m.cr, m.cpitch, flags >> 8, cy0,
                  cy1, cx0, cx1, tid);
    staged = py.p && pb.p && pr.p;
  }
  if (staged && m.map) {
    if (wide) {
      const int ws = mstride >> 2;
      Walk w(tid, ws);
      for (int i = tid; i < uh * ws; i += kThreads, w.next())
        copy_async<16>(mps + 4 * i, packed + static_cast<long long>(
                                                 uy0 + w.r) * m.w +
                                        ux0 + 4 * w.c);
    } else {
      Walk w(tid, uw);
      for (int i = tid; i < uh * uw; i += kThreads, w.next())
        copy_async<4>(mps + i, packed + static_cast<long long>(uy0 + w.r) *
                                            m.w + ux0 + w.c);
    }
  }
  copy_async_wait();
  __syncthreads();
  if (staged) {
    const int qh = bh >> 1, qw = bw >> 1;
    Walk w(tid, max(qw, 1));
    for (int i = tid; i < qh * qw; i += kThreads, w.next()) {
      unsigned q[2][2];
      bgr_quad(m, py, pb, pr, by0 + 2 * w.r, bx0 + 2 * w.c, q);
      uint2* row0 = reinterpret_cast<uint2*>(st + 2 * w.r * bw + 2 * w.c);
      row0[0] = make_uint2(q[0][0], q[0][1]);
      row0[bw >> 1] = make_uint2(q[1][0], q[1][1]);
    }
  }
  __syncthreads();
  const StagedU su{st, mps, by0, bx0, bw, uy0, ux0, mstride};
  float* s = stage[warp];
  const int x = x0 + lane;
  const int valid = min(32, tw - x0) * 3;
  for (int y = y0 + warp; y < min(y0 + rows, th); y += kWarpsPerCta) {
    float o[3] = {0.f, 0.f, 0.f};
    if (x < tw && y < m.oh && x < m.ow) {
      const Tap ty = m.resize ? taps[0][y - y0] : Tap{y, y, 0.f};
      const Tap tx = m.resize ? taps[1][lane] : Tap{x, x, 0.f};
      if (staged)
        output_px(m, su, ty, tx, lut, to_rgb, o);
      else
        output_px(m, DirectU{sd}, ty, tx, lut, to_rgb, o);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 3; ++c) s[lane * 3 + c] = o[c];
    __syncwarp();
    float* row = m.dst + (static_cast<long long>(y) * tw + x0) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int i = c * 32 + lane;
      if (i < valid) row[i] = s[i];
    }
  }
}

// The geometry tables of one image's content tiles (desc: its descriptor
// row): per tile its U rectangle (first row, last row, first column, last
// column) and its footprint, the least and largest map row and column
// (whole pixels) over that rectangle (the rectangle itself without a
// map), (min y, max y, min x, max x), with min x kFarFootprint where a map
// entry lies 1024 px or more from its pixel (the packed map cannot hold
// it: the tile then reads the planes directly).
__global__ void __launch_bounds__(kThreads)
    footprint_kernel(const long long* __restrict__ desc, int th, int tw,
                     int4* __restrict__ out) {
  __shared__ int box[5];
  const int tid = threadIdx.x;
  if (tid < 5) box[tid] = tid == 4 ? 0 : (tid & 1) ? -(1 << 30) : (1 << 30);
  __syncthreads();
  const Img m = load_img(desc);
  const int rows = static_cast<int>(desc[22]) * kWarpsPerCta;
  const TileRect tr = tile_rect(m, blockIdx.x, rows, th, tw);
  if (!m.map) {
    if (tid == 0) {
      out[2 * blockIdx.x] = make_int4(tr.uy0, tr.uy1, tr.ux0, tr.ux1);
      out[2 * blockIdx.x + 1] =
          make_int4(tr.uy0, tr.uy1 - 1, tr.ux0, tr.ux1 - 1);
    }
    return;
  }
  const int uw = tr.ux1 - tr.ux0 + 1, un = (tr.uy1 - tr.uy0 + 1) * uw;
  int lo_y = 1 << 30, hi_y = -(1 << 30), lo_x = 1 << 30, hi_x = -(1 << 30);
  bool far = false;
  const int2* mp = reinterpret_cast<const int2*>(m.map);
  Walk k(tid, uw);
  for (int i = tid; i < un; i += kThreads, k.next()) {
    const int2 e =
        __ldg(mp + static_cast<long long>(tr.uy0 + k.r) * m.w + tr.ux0 + k.c);
    const int ey = e.y >> 5, ex = e.x >> 5;
    lo_y = min(lo_y, ey);
    hi_y = max(hi_y, ey);
    lo_x = min(lo_x, ex);
    hi_x = max(hi_x, ex);
    const int dy = ey - (tr.uy0 + k.r), dx = ex - (tr.ux0 + k.c);
    far |= dy < -1024 || dy > 1023 || dx < -1024 || dx > 1023;
  }
  atomicMin(&box[0], lo_y);
  atomicMax(&box[1], hi_y);
  atomicMin(&box[2], lo_x);
  atomicMax(&box[3], hi_x);
  if (far) box[4] = 1;
  __syncthreads();
  if (tid == 0) {
    out[2 * blockIdx.x] = make_int4(tr.uy0, tr.uy1, tr.ux0, tr.ux1);
    out[2 * blockIdx.x + 1] =
        make_int4(box[0], box[1], box[4] ? kFarFootprint : box[2], box[3]);
  }
}

// The f32 resize's taps of every output row (then every column) of one
// image, as (s0, s1, f's bits, 0), and 31 more past the last (copies of
// it), so a tile reads 32 without a bound.
__global__ void taps_kernel(const long long* __restrict__ desc,
                            int4* __restrict__ rows_out,
                            int4* __restrict__ cols_out) {
  const Img m = load_img(desc);
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int nr = m.oh + 31, nc = m.ow + 31;
  if (i < nr) {
    const Tap t = axis_tap(min(i, m.oh - 1), m.fsy, m.u8h);
    rows_out[i] = make_int4(t.s0, t.s1, __float_as_int(t.f), 0);
  } else if (i - nr < nc) {
    const Tap t = axis_tap(min(i - nr, m.ow - 1), m.fsx, m.u8w);
    cols_out[i - nr] = make_int4(t.s0, t.s1, __float_as_int(t.f), 0);
  }
}

// Each entry of an undistortion map (h, w, 2) int32 in 1/32 px, packed
// into 32 bits for the stage: its whole-pixel displacement from its own
// pixel (x then y, 11 bits each, two's complement) and its fractions (x
// then y, 5 bits each).  Entries 1024 px or more away wrap; their tiles
// are marked far by footprint_kernel.
__global__ void pack_map_kernel(const int2* __restrict__ map, int h, int w,
                                unsigned* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<long long>(h) * w) return;
  const int y = static_cast<int>(i / w);
  const int x = static_cast<int>(i - static_cast<long long>(y) * w);
  const int2 e = map[i];
  const int dx = (e.x >> 5) - x, dy = (e.y >> 5) - y;
  out[i] = static_cast<unsigned>(dx & 2047) |
           static_cast<unsigned>(dy & 2047) << 11 |
           static_cast<unsigned>(e.x & 31) << 22 |
           static_cast<unsigned>(e.y & 31) << 27;
}

}  // namespace

// One launch over n_img images: desc on the card, (n_img, 30) int64 rows
// and then n_groups (first launch tile, first image, size, 0) groups, each
// of images in consecutive rows that share a geometry and a map.  A row's
// words: 0-21 the image (Img); 22 its tile height in warps' rows; 23 bits
// 0-7 the Y plane's, 8-15 the chroma planes' copy alignment (16, 8 or 1
// bytes); 24 its packed map (pack_map_kernel) or 0; 25 its geometry table
// (footprint_kernel); 26, 27 its f32 resize taps (taps_kernel, 31 entries
// past the last); 28 its content tiles, the rest of its tiles zero the
// canvas around them.
// norm_lut (3, 256) f32: (v - mean[c]) / std[c].  Every image is written
// to a (th, tw, 3) f32 canvas.  Returns a cudaError_t (0 on success).
extern "C" int rectify_launch(const long long* desc, int n_img, int n_groups,
                              int n_tiles, int th, int tw,
                              const float* norm_lut, int to_rgb,
                              void* stream) {
  if (n_img <= 0 || n_tiles <= 0 || th <= 0 || tw <= 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      rectify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDynamicSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rectify_kernel<<<n_tiles, dim3(32, kWarpsPerCta), kDynamicSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      desc, n_img, n_groups, th, tw, norm_lut, to_rgb);
  return static_cast<int>(cudaGetLastError());
}

// The footprint table of one image's content tiles (desc: its geometry
// row on the card, kernels/rectify.py:_geometry_row): `table` (n_tiles, 2)
// int4 (footprint_kernel).  Returns a cudaError_t (0 on success).
extern "C" int rectify_footprint_launch(const long long* desc, int th, int tw,
                                        int n_tiles, void* table,
                                        void* stream) {
  if (n_tiles <= 0) return 0;
  footprint_kernel<<<n_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      desc, th, tw, static_cast<int4*>(table));
  return static_cast<int>(cudaGetLastError());
}

// The f32 resize's taps of one image (desc as above): `row_taps` (oh + 31)
// and `col_taps` (ow + 31) int4 (taps_kernel).  Returns a cudaError_t.
extern "C" int rectify_taps_launch(const long long* desc, int oh, int ow,
                                   void* row_taps, void* col_taps,
                                   void* stream) {
  taps_kernel<<<(oh + ow + 62 + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      desc, static_cast<int4*>(row_taps), static_cast<int4*>(col_taps));
  return static_cast<int>(cudaGetLastError());
}

// The packed form (h, w) of an undistortion map (h, w, 2) int32
// (pack_map_kernel).  Returns a cudaError_t.
extern "C" int rectify_pack_map_launch(const void* map, int h, int w,
                                       void* packed, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  if (n <= 0) return 0;
  pack_map_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(map), h, w, static_cast<unsigned*>(packed));
  return static_cast<int>(cudaGetLastError());
}
