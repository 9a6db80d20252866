// Fused 3x3 convolution (stride 1, zero padding = dilation) for Hopper,
// sm_90a: the template shared by qconv.cu (s8 x s8 -> s32) and bconv.cu
// (bf16 x bf16 -> f32).  Each .cu file states which TPU kernel it replaces
// and what bounds it; this file is the design they share.
//
//   out[n, h, w, o] = epi( sum_{dy, dx, c} x[n, h + (dy-1)d, w + (dx-1)d, c]
//                                          * wt[o, dy, dx, c] )
//   epi(a) = relu?( float(a) * scale[o] + shift[o] ),  rounded separately
//
// Layouts: x is NHWC (an NCHW channels_last tensor), wt is OHWI (an OIHW
// channels_last tensor), out is NHWC.  So both GEMM operands keep their
// reduction axis (c) contiguous, which is what mma.sync's row.col form
// wants, and the kernel reads the activation in place: no padded copy, no
// shifted copies, no im2col buffer.
//
// Design: a direct implicit GEMM, M = N*H*W pixels, N = Co, K = 9*C.
//   * A block computes a 128-pixel x 128-channel output tile with 8 warps
//     (2 along pixels x 4 along channels, 64 x 32 each), accumulating in
//     registers (s32 or f32) across all 9 taps and all input channels.
//   * K advances 64 bytes of input channels of one tap per step (64 s8 or
//     32 bf16 channels): cp.async copies the 128 x 64-byte slabs of x and
//     wt into a 3-stage shared-memory ring; pixels whose tap falls outside
//     the image are zero-filled by the copy (src-size 0), which is the
//     convolution's zero padding.
//   * Shared rows are padded to 80 bytes, so the 32-bit fragment loads of
//     a warp hit 32 distinct banks.
//   * The s8 m16n8k32 and bf16 m16n8k16 mma.sync fragments place the same
//     bytes in the same registers (4 consecutive bytes of one row per
//     register), so one load sequence feeds both element types.
//   * The epilogue converts, scales, shifts and applies ReLU in registers
//     and stores each output element once.
// Left for later (it is what separates this from the card's peak): wgmma
// with TMA and a producer warp, a persistent tile scheduler, a wider warp
// tile (64 x 32 reads 3 KB of shared memory per 16 mma, so shared-memory
// bandwidth bounds it near two thirds of mma.sync's rate), and coalesced
// stores through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int kBM = 128;          // output pixels per block
constexpr int kBN = 128;          // output channels per block
constexpr int kBKBytes = 64;      // input-channel bytes per pipeline step
constexpr int kRowBytes = 80;     // shared row stride (64 + 16 pad)
constexpr int kStages = 3;
constexpr int kThreads = 256;     // 8 warps: 2 (pixels) x 4 (channels)
constexpr int kTileBytes = kBM * kRowBytes;             // one operand slab
constexpr int kSmemBytes = kStages * 2 * kTileBytes;    // 61,440 bytes

struct S8 {
  using In = int8_t;
  using Acc = int32_t;
  __device__ __forceinline__ static void mma(int32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static float to_float(int32_t v) {
    return __int2float_rn(v);
  }
};

struct BF16 {
  using In = __nv_bfloat16;
  using Acc = float;
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;   // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class T, typename OutT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const typename T::In* __restrict__ x,
               const typename T::In* __restrict__ wt,
               const float* __restrict__ scale,
               const float* __restrict__ shift, OutT* __restrict__ out,
               int n_img, int h, int w, int c, int co, int dil, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int64_t m_total = (int64_t)n_img * h * w;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // Copy roles: rows lrow and lrow + 64 of each slab, 16-byte chunk `chunk`.
  const int chunk = tid & 3, lrow = tid >> 2;
  int pix_n[2], pix_h[2], pix_w[2];
  bool pix_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t p = m0 + lrow + 64 * i;
    pix_ok[i] = p < m_total;
    const int64_t q = pix_ok[i] ? p : 0;
    pix_w[i] = (int)(q % w);
    pix_h[i] = (int)((q / w) % h);
    pix_n[i] = (int)(q / ((int64_t)w * h));
  }
  const int64_t c_bytes = (int64_t)c * sizeof(typename T::In);
  const int k_chunks = (int)(c_bytes / kBKBytes);   // steps per tap
  const int k_iters = 9 * k_chunks;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(wt);

  auto load_stage = [&](int slot, int kit) {
    const int tap = kit / k_chunks;
    const int64_t koff =
        (int64_t)(kit - tap * k_chunks) * kBKBytes + chunk * 16;
    const int dy = (tap / 3 - 1) * dil, dx = (tap % 3 - 1) * dil;
    unsigned char* a_s = smem + slot * 2 * kTileBytes;
    unsigned char* b_s = a_s + kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lrow + 64 * i;
      const int hh = pix_h[i] + dy, ww = pix_w[i] + dx;
      const bool ok = pix_ok[i] && hh >= 0 && hh < h && ww >= 0 && ww < w;
      const unsigned char* src =
          ok ? xb + (((int64_t)pix_n[i] * h + hh) * w + ww) * c_bytes + koff
             : xb;
      cp_async16(a_s + r * kRowBytes + chunk * 16, src, ok);
      const int oc = n0 + r;
      const bool wok = oc < co;
      const unsigned char* wsrc =
          wok ? wb + ((int64_t)oc * 9 + tap) * c_bytes + koff : wb;
      cp_async16(b_s + r * kRowBytes + chunk * 16, wsrc, wok);
    }
  };

  typename T::Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_iters) load_stage(s, s);
    cp_async_commit();
  }

  for (int kit = 0; kit < k_iters; ++kit) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step kit landed; slot (kit - 1) % kStages is free
    const int next = kit + kStages - 1;
    if (next < k_iters) load_stage(next % kStages, next);
    cp_async_commit();

    const unsigned char* a_s = smem + (kit % kStages) * 2 * kTileBytes;
    const unsigned char* b_s = a_s + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {       // two 32-byte mma depths
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* p =
            a_s + (warp_m * 64 + mt * 16 + g) * kRowBytes + ks * 32 + t * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* p =
            b_s + (warp_n * 32 + nt * 8 + g) * kRowBytes + ks * 32 + t * 4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) T::mma(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + t * 2;
    if (col >= co) continue;              // co % 8 == 0: col + 1 < co too
    const float s0 = scale[col], s1 = scale[col + 1];
    const float h0 = shift[col], h1 = shift[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t p = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (p >= m_total) continue;
        float v0 = __fadd_rn(__fmul_rn(T::to_float(acc[mt][nt][2 * half]),
                                       s0), h0);
        float v1 = __fadd_rn(
            __fmul_rn(T::to_float(acc[mt][nt][2 * half + 1]), s1), h1);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        store_pair(out + p * co + col, v0, v1);
      }
    }
  }
}

// Launches on `stream`; returns cudaGetLastError() (or the attribute call's
// error).  The caller checks shapes: c * sizeof(In) % 64 == 0, co % 8 == 0,
// x and wt 16-byte aligned, out 8-byte aligned, n_img * h * w > 0.
template <class T, typename OutT>
int launch(const void* x, const void* wt, const float* scale,
           const float* shift, void* out, int n_img, int h, int w, int c,
           int co, int dil, int relu, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<T, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t m_total = (int64_t)n_img * h * w;
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM),
                  (unsigned)((co + kBN - 1) / kBN));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const typename T::In*>(x),
      static_cast<const typename T::In*>(wt), scale, shift,
      static_cast<OutT*>(out), n_img, h, w, c, co, dil, relu);
  return (int)cudaGetLastError();
}

}  // namespace conv3x3
