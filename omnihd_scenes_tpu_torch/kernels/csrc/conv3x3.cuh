// Fused 3x3 convolution (stride 1, zero padding = dilation) for Hopper,
// sm_90a: the template shared by qconv.cu (s8 x s8 -> s32) and bconv.cu
// (bf16 x bf16 -> f32).  Each .cu file states which TPU kernel it replaces;
// this file is the design they share.
//
//   out[n, h, w, o] = epi( sum_{dy, dx, c} x[n, h + (dy-1)d, w + (dx-1)d, c]
//                                          * wt[o, dy, dx, c] )
//   epi(a) = relu?( float(a) * scale[o] + shift[o] ),  rounded separately
//
// Layouts: x is NHWC (an NCHW channels_last tensor), wt is OHWI (an OIHW
// channels_last tensor), out is NHWC.  Both GEMM operands keep their
// reduction axis (c) contiguous: K-major, the only form wgmma takes for s8.
//
// What bounds it on an H100: tensor-core operations.  At the serving
// shapes a call does 0.92-2.9 T multiply-adds x 2 against 0.1-0.6 GB of
// input and output, 1,500-6,000 operations per byte, far above the card's
// ~590 (int8) or ~295 (bf16) operations per byte of HBM bandwidth; so the
// bound is 2 * 9 * C * Co * N * H * W over 1,979 TOP/s (s8) or 989 TFLOP/s
// (bf16), e.g. 0.467 ms (s8) and 0.934 ms (bf16) at (24, 256, 136, 240)
// -> 256.
//
// Design: an implicit GEMM, M = output pixels, N = Co, K = 9 taps x C.
//   * A block computes 128 output pixels x BN channels (BN = 256 when Co
//     is a multiple of 256, else 128; template instances).  Its 128 pixels
//     are a BH x BW rectangle of one image (2x64, 4x32, 8x16 or 16x8, the
//     wrapper picks the one that wastes the fewest pixels).
//   * Operand A through TMA, no im2col buffer: x is a 4-D tensor map
//     (C, W, H, N) with 128-byte swizzle, and for tap (dy, dx) and one
//     128-byte slice of channels one cp.async.bulk.tensor.4d load brings
//     the (128 B, BW, BH, 1) box at (c0, w0 + (dx-1)d, h0 + (dy-1)d, n).
//     Tiled mode zero-fills every element outside the tensor, including
//     negative coordinates: that fill is the convolution's zero padding at
//     every dilation, with no masks in the kernel.  The box lands as 128
//     rows x 128 B, K-major and swizzled, which is the layout wgmma reads.
//     (TMA's im2col mode was not taken: its box walks pixels along W only,
//     while tiled boxes give the 2-D rectangle and any dilation directly.)
//   * Operand B through TMA: wt viewed as the 2-D tensor (Co, 9C), boxes
//     of (BN rows, 128 B) with the same swizzle; rows at or above Co fill
//     with zeros.
//   * Tensor cores through wgmma.mma_async m64nBNk32 s8 or m64nBNk16 bf16,
//     both operands from shared memory through matrix descriptors.  Two
//     consumer warpgroups each take 64 of the 128 pixel rows; one 128-byte
//     K slab is 4 wgmma per warpgroup for both types.
//   * Pipeline: a ring of kStages slabs in dynamic shared memory with full
//     and empty mbarriers.  One producer thread (warpgroup 2, after
//     setmaxnreg.dec) issues all TMA loads; the consumer warpgroups (after
//     setmaxnreg.inc) wait on the full barrier, keep one wgmma group in
//     flight and release a slab once the wgmma that read it has completed.
//     No block barrier in the K loop.
//   * Persistent schedule: one block per SM walks tiles blockIdx.x,
//     + gridDim.x, ... in an order where neighbouring blocks share input
//     tiles in L2.  The ring runs on across tiles, so the producer loads
//     the next tile while the consumers store the last one, and no block
//     pays a launch, barrier set-up or pipeline fill per tile.
//   * Epilogue: s32 -> f32 (__int2float_rn), __fmul_rn by scale,
//     __fadd_rn of shift (never an FMA, so the result equals the plain
//     version's), optional ReLU; the tile goes through a 32 KB staging
//     buffer beside the ring, 256 bytes of channels per pass, as swizzled
//     128-byte column slabs, and back to memory by TMA stores, which clip
//     pixels outside the image and channels >= Co.
// Left for later: the consumers still stop the tensor cores for the
// epilogue (two warpgroups on alternating tiles would hide it, but a
// 128 x 256 tile per warpgroup does not fit in registers), and each block
// reads its own copy of every weight slab from L2 (a cluster of two
// blocks sharing them by TMA multicast would halve that traffic).

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int kBM = 128;                     // output pixels per block
constexpr int kSlabBytes = 128;              // K bytes per pipeline stage
constexpr int kConsumerThreads = 256;        // warpgroups 0 and 1
constexpr int kThreads = 384;                // + producer warpgroup 2
constexpr int kABytes = kBM * kSlabBytes;    // 16 KB per stage
// Error codes beside cudaError_t's, read by kernels/_conv3x3.py.
constexpr int kErrNoEncoder = 900001;        // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 910000;           // + CUresult of the encoder
constexpr int kErrTile = 900002;             // tile shape not taken

// The epilogue's staging buffer: per consumer warpgroup, kStagePass
// column slabs of 64 rows x 128 B, stored by TMA while the next pass or
// tile goes on.
constexpr int kStagePass = 2;
constexpr int kStagingBytes = 2 * kStagePass * 64 * kSlabBytes;   // 32 KB

template <int BN>
struct Tiling {
  static constexpr int kBBytes = BN * kSlabBytes;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kRingBytes = kStages * (kABytes + kBBytes);
  // ring, staging, then the full/empty barriers; + 1 KB so the ring can
  // start on a 1024-byte boundary (the 128-byte swizzle atom).
  static constexpr int kSmemBytes =
      kRingBytes + kStagingBytes + 2 * kStages * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

// The accumulator list of one wgmma, as inline-asm operands.
#define CONV3X3_ACC8(C, a, i)                                              \
  C(a[i]), C(a[i + 1]), C(a[i + 2]), C(a[i + 3]), C(a[i + 4]), C(a[i + 5]), \
      C(a[i + 6]), C(a[i + 7])
#define CONV3X3_ACC64(C, a)                                                 \
  CONV3X3_ACC8(C, a, 0), CONV3X3_ACC8(C, a, 8), CONV3X3_ACC8(C, a, 16),     \
      CONV3X3_ACC8(C, a, 24), CONV3X3_ACC8(C, a, 32), CONV3X3_ACC8(C, a, 40), \
      CONV3X3_ACC8(C, a, 48), CONV3X3_ACC8(C, a, 56)
#define CONV3X3_ACC128(C, a)                                                \
  CONV3X3_ACC64(C, a), CONV3X3_ACC8(C, a, 64), CONV3X3_ACC8(C, a, 72),      \
      CONV3X3_ACC8(C, a, 80), CONV3X3_ACC8(C, a, 88), CONV3X3_ACC8(C, a, 96), \
      CONV3X3_ACC8(C, a, 104), CONV3X3_ACC8(C, a, 112),                      \
      CONV3X3_ACC8(C, a, 120)
#define CONV3X3_F(x) "+f"(x)
#define CONV3X3_R(x) "+r"(x)
#define CONV3X3_D0_63                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define CONV3X3_D64_127                                                     \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "   \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "   \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d += A(64 x 32 B, K-major) * B(BN x 32 B, K-major)^T, both from shared
// memory through descriptors; scale-d is always 1 (d starts at zero).
struct S8 {
  using In = int8_t;
  using Acc = int32_t;
  template <int BN>
  __device__ __forceinline__ static void mma(int32_t (&d)[BN / 2],
                                             uint64_t da, uint64_t db) {
    if constexpr (BN == 256) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
          "{" CONV3X3_D0_63 CONV3X3_D64_127 "}, %128, %129, p;\n}\n"
          : CONV3X3_ACC128(CONV3X3_R, d)
          : "l"(da), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
          "{" CONV3X3_D0_63 "}, %64, %65, p;\n}\n"
          : CONV3X3_ACC64(CONV3X3_R, d)
          : "l"(da), "l"(db), "r"(1));
    }
  }
  __device__ __forceinline__ static float to_float(int32_t v) {
    return __int2float_rn(v);
  }
  __device__ __forceinline__ static void fence(int32_t& v) {
    asm volatile("" : "+r"(v)::"memory");
  }
};

struct BF16 {
  using In = __nv_bfloat16;
  using Acc = float;
  template <int BN>
  __device__ __forceinline__ static void mma(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
    if constexpr (BN == 256) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
          "{" CONV3X3_D0_63 CONV3X3_D64_127 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
          : CONV3X3_ACC128(CONV3X3_F, d)
          : "l"(da), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{" CONV3X3_D0_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
          : CONV3X3_ACC64(CONV3X3_F, d)
          : "l"(da), "l"(db), "r"(1));
    }
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
  __device__ __forceinline__ static void fence(float& v) {
    asm volatile("" : "+f"(v)::"memory");
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major operand with 128-byte swizzle: rows of 128 B, 8-row atoms of
// 1024 B (stride byte offset 1024 >> 4 = 64; the leading byte offset is
// unused for this layout and set to 1).  Advancing K by 32 B inside the
// swizzled row adds 2 to the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Tile t -> (image, tile row, tile column, channel tile), the channel
// tile fastest, so the blocks working at one time share input tiles in L2.
struct Tile {
  int n, h0, w0, co0;
  __device__ __forceinline__ Tile(int t, int bh, int bw, int tiles_h,
                                  int tiles_w, int co_tiles, int bn) {
    co0 = (t % co_tiles) * bn;
    t /= co_tiles;
    w0 = (t % tiles_w) * bw;
    t /= tiles_w;
    h0 = (t % tiles_h) * bh;
    n = t / tiles_h;
  }
};

template <class T, typename OutT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap out_map,
               const float* __restrict__ scale,
               const float* __restrict__ shift, int c, int co, int dil,
               int relu, int bh, int bw, int tiles_h, int tiles_w,
               int co_tiles, int n_tiles) {
  using Cfg = Tiling<BN>;
  constexpr int kStages = Cfg::kStages;
  constexpr int kInPer128 = kSlabBytes / sizeof(typename T::In);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_ring = smem;
  unsigned char* b_ring = smem + kStages * kABytes;
  unsigned char* staging = smem + Cfg::kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStagingBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                        // the producer
      mbar_init(&empty[s], kConsumerThreads / 32);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // barriers ready; the roles split below for good

  const int c_slabs = c / kInPer128;                 // K slabs per tap
  const int k_iters = 9 * c_slabs;
  if (wg == 2) {
    // Producer: one thread keeps the ring full, running ahead into the
    // block's next tile while the consumers store the last one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile(t, bh, bw, tiles_h, tiles_w, co_tiles, BN);
        for (int k = 0; k < k_iters; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);       // first lap passes
          mbar_expect_tx(&full[stage], kABytes + Cfg::kBBytes);
          const int tap = k / c_slabs, slab = k - tap * c_slabs;
          const int dy = (tap / 3 - 1) * dil, dx = (tap % 3 - 1) * dil;
          tma_load_4d(a_ring + stage * kABytes, &x_map, &full[stage],
                      slab * kInPer128, tile.w0 + dx, tile.h0 + dy, tile.n);
          tma_load_2d(b_ring + stage * Cfg::kBBytes, &w_map, &full[stage],
                      tap * c + slab * kInPer128, tile.co0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns pixel rows [64 wg, 64 wg + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    // This warpgroup's half of the staging buffer: kStagePass column
    // slabs of [64 rows][128 B], swizzled like the store's tensor map.
    unsigned char* staged = staging + wg * (kStagingBytes / 2);
    constexpr int kSlabCols = kSlabBytes / sizeof(OutT);
    constexpr int kPassCols = kStagePass * kSlabCols;
    typename T::Acc acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tile(t, bh, bw, tiles_h, tiles_w, co_tiles, BN);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int k = 0; k < k_iters; ++k) {
        mbar_wait(&full[stage], phase);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) T::fence(acc[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint64_t da =
            smem_desc(a_ring + stage * kABytes + wg * 64 * kSlabBytes);
        const uint64_t db = smem_desc(b_ring + stage * Cfg::kBBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          T::template mma<BN>(acc, da + 2 * kk, db + 2 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) T::fence(acc[i]);
        // The group of step k - 1 has completed: its slab is free.
        if (k > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) T::fence(acc[i]);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue, kPassCols columns at a time through the staging buffer;
      // the producer is already loading the next tile.
#pragma unroll
      for (int pass = 0; pass < BN / kPassCols; ++pass) {
        // The last TMA store of this warpgroup has read the buffer.
        if (leader)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
        for (int j = pass * kPassCols / 8; j < (pass + 1) * kPassCols / 8;
             ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          const bool live = tile.co0 + col < co;     // co % 8 == 0
          const float2 s = live ? __ldg(reinterpret_cast<const float2*>(
                                      scale + tile.co0 + col))
                                : make_float2(0.f, 0.f);
          const float2 b = live ? __ldg(reinterpret_cast<const float2*>(
                                      shift + tile.co0 + col))
                                : make_float2(0.f, 0.f);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = warp * 16 + (lane >> 2) + half * 8;
            float v0 = __fadd_rn(
                __fmul_rn(T::to_float(acc[4 * j + 2 * half]), s.x), b.x);
            float v1 = __fadd_rn(
                __fmul_rn(T::to_float(acc[4 * j + 2 * half + 1]), s.y), b.y);
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const int pcol = col - pass * kPassCols;
            const int byte = (pcol % kSlabCols) * (int)sizeof(OutT);
            unsigned char* p =
                staged + (pcol / kSlabCols) * 64 * kSlabBytes +
                row * kSlabBytes +
                ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
            store_pair(reinterpret_cast<OutT*>(p), v0, v1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        if (leader) {
          for (int s = 0; s < kStagePass; ++s) {
            const int c0 = tile.co0 + pass * kPassCols + s * kSlabCols;
            if (c0 < co)
              tma_store_4d(&out_map, staged + s * 64 * kSlabBytes, c0,
                           tile.w0, tile.h0 + wg * (bh / 2), tile.n);
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dims (innermost first) with 128-byte swizzle;
// elements outside the tensor read as zero and are not written.
inline int make_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                    const void* ptr, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapL2promotion l2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dtype, rank, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, l2,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <typename V>
constexpr CUtensorMapDataType map_type() {
  if constexpr (sizeof(V) == 1) return CU_TENSOR_MAP_DATA_TYPE_UINT8;
  else if constexpr (sizeof(V) == 4) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <class T, typename OutT, int BN>
int launch_bn(const void* x, const void* wt, const float* scale,
              const float* shift, void* out, int n_img, int h, int w, int c,
              int co, int dil, int relu, int bh, int bw,
              cudaStream_t stream) {
  using In = typename T::In;
  constexpr cuuint64_t es = sizeof(In), oes = sizeof(OutT);
  CUtensorMap x_map, w_map, out_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)n_img};
  const cuuint64_t x_strides[3] = {c * es, w * c * es,
                                   (cuuint64_t)h * w * c * es};
  const cuuint32_t x_box[4] = {(cuuint32_t)(kSlabBytes / es), (cuuint32_t)bw,
                               (cuuint32_t)bh, 1};
  int err = make_map(&x_map, map_type<In>(), 4, x, x_dims, x_strides, x_box,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err) return err;
  const cuuint64_t w_dims[2] = {(cuuint64_t)9 * c, (cuuint64_t)co};
  const cuuint64_t w_strides[1] = {9 * c * es};
  const cuuint32_t w_box[2] = {(cuuint32_t)(kSlabBytes / es), BN};
  err = make_map(&w_map, map_type<In>(), 2, wt, w_dims, w_strides, w_box,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err) return err;
  const cuuint64_t o_dims[4] = {(cuuint64_t)co, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)n_img};
  const cuuint64_t o_strides[3] = {co * oes, w * co * oes,
                                   (cuuint64_t)h * w * co * oes};
  const cuuint32_t o_box[4] = {(cuuint32_t)(kSlabBytes / oes), (cuuint32_t)bw,
                               (cuuint32_t)(bh / 2), 1};
  err = make_map(&out_map, map_type<OutT>(), 4, out, o_dims, o_strides, o_box,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (err) return err;

  auto kernel = conv3x3_kernel<T, OutT, BN>;
  constexpr int smem = Tiling<BN>::kSmemBytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles_h = (h + bh - 1) / bh, tiles_w = (w + bw - 1) / bw;
  const int co_tiles = (co + BN - 1) / BN;
  const long long tiles = (long long)n_img * tiles_h * tiles_w * co_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // Persistent: one block per SM (its shared memory admits no second),
  // each walking tiles blockIdx.x, + gridDim.x, ...
  int device = 0, sms = 0;
  cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cerr != cudaSuccess) return (int)cerr;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, smem, stream>>>(
      x_map, w_map, out_map, scale, shift, c, co, dil, relu, bh, bw, tiles_h,
      tiles_w, co_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns 0, a cudaError_t, or one of the kErr codes
// above.  The caller checks shapes: c * sizeof(In) % 128 == 0, co % 8 == 0,
// x and wt 16-byte aligned, scale and shift 8-byte aligned, n_img * h * w
// > 0; bn is 256 when co % 256 == 0, else 128; (bh, bw) is one of (2, 64),
// (4, 32), (8, 16), (16, 8).
template <class T, typename OutT>
int launch(const void* x, const void* wt, const float* scale,
           const float* shift, void* out, int n_img, int h, int w, int c,
           int co, int dil, int relu, int bh, int bw, int bn,
           cudaStream_t stream) {
  if (bh * bw != kBM || bh < 2 || bh > 16 || bh % 2) return kErrTile;
  if (bn == 256)
    return launch_bn<T, OutT, 256>(x, wt, scale, shift, out, n_img, h, w, c,
                                   co, dil, relu, bh, bw, stream);
  if (bn == 128)
    return launch_bn<T, OutT, 128>(x, wt, scale, shift, out, n_img, h, w, c,
                                   co, dil, relu, bh, bw, stream);
  return kErrTile;
}

}  // namespace conv3x3
