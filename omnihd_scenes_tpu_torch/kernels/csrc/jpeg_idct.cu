// JPEG inverse DCT for Hopper, sm_90a: libjpeg's jpeg_idct_islow
// (jidctint.c) over every 8x8 block of a batch of decoded JPEGs, in one
// launch, or for a component decoded at a reduced size jidctred.c's
// jpeg_idct_4x4 / 2x2 / 1x1 (the DCT-domain downscale of a decode with
// scale_denom 2, 4 or 8), any mix of sizes in the launch.  No TPU kernel
// is replaced: the JAX package decodes its camera JPEGs on the host with
// cv2.imread, i.e. libjpeg-turbo's islow IDCT
// (omnihd_scenes_tpu/data/image_loading.py:177), and with
// image_fast_decode its reduced ones (IMREAD_REDUCED_COLOR_{2,4,8},
// :124-126); the card's decode runs the same integer arithmetic, so its
// planes equal libjpeg's bit for bit.  kernels/jpeg_idct.py holds the
// plain PyTorch version, op for op.
//
// Arithmetic (jidctint.c, CONST_BITS 13, PASS1_BITS 2): each coefficient
// times its quantisation step (DEQUANTIZE), the 1-D islow transform down
// each column, DESCALE by CONST_BITS - PASS1_BITS, the same transform
// along each row, DESCALE by CONST_BITS + PASS1_BITS + 3, and the result
// through IDCT_range_limit with & RANGE_MASK, i.e. the table that
// jdmaster.c:prepare_range_limit_table lays out (an index read as a
// signed 10-bit value, plus CENTERJSAMPLE, clamped to 0..255).  Every sum
// and product is a 32-bit word that wraps, as unsigned arithmetic here
// and as int32 tensors in the plain version; wrapping is a ring, so both
// give the same words in any order.  Two rewrites that give the same
// words: each pass's rounding constant rides on the (v0 +- v4) << 13
// terms that every output sums, and the row pass's also carries 512 << 18
// (libjpeg-turbo's trick: the DC term absorbs them), so a pixel is
// ((sum >> 18) & 1023) - 384, saturated to 0..255 -- the range limit, as
// (idx ^ 512) - 512 + 128 == ((idx + 512) & 1023) - 384.
//
// The reduced transforms (jidctred.c) are the same arithmetic on fewer
// terms, in the same wrapping words: 4x4 reads no coefficient row or
// column 4 and descales by 12 and 19 bits, 2x2 reads rows and columns 0,
// 1, 3, 5, 7 only and descales by 13 and 20, 1x1 is DESCALE(DC * q, 3);
// each result goes through the same range limit.
//
// Layout: the coefficients of component k (int16, natural order) are
// blocks [start_k, start_k + rows_k * cols_k) of one buffer, row-major on
// its block grid; its plane (u8, rows_k * s_k by cols_k * s_k at its
// scaled size s_k) starts at byte out_k of the output buffer, the planes
// one after the other, each from a 16-byte boundary
// (kernels/jpeg_idct.py:plane_offsets), so a lane's s-byte row stores
// align; at s = 8 a block's pixels sit where its 64 coefficients sat.
//
// Bound: bytes (int16 coefficients in, u8 planes out, once each) over the
// memory rate.  Design (the host cuts the work, the card only streams):
//   * kernels/jpeg_idct.py:idct_chunks cuts every block row of every
//     component into chunks of up to 32 consecutive blocks (first block,
//     component, block row, first column, count), in NumPy, once a call;
//     no thread searches the components or divides.
//   * A persistent grid walks the chunks, CTA b taking chunks b, b +
//     grid, ...: 3 CTAs an SM, each of 5 consumer warps and a producer
//     warp (96 registers a thread with nvcc 12.8).  In each CTA one
//     producer thread keeps the next chunks in flight into a ring of 3
//     stages per consumer warp: the coefficients by TMA
//     (cp.async.bulk.tensor.2d of 8 blocks x 128 bytes; the 2-D tensor
//     copy, not a 1-D one, for its 128-byte swizzle), the component's
//     quant row by a 1-D cp.async.bulk when the stage held another
//     component's, and the chunk's output offset and pitch, all
//     completing on the stage's full mbarrier.  The rest of its warp
//     reads the chunk rows 32 chunks ahead, one a lane, so no copy waits
//     for a dependent global load.
//   * A consumer warp takes a chunk, one lane a block: eight 16-byte
//     shared loads (the swizzle puts the 8 lanes of a quarter warp on 8
//     different bank groups), the quant rows as broadcasts, then it frees
//     the stage and runs the whole block in registers -- dequantise, the
//     column pass, the row pass, the range limit with cvt.pack.sat -- and
//     stores each pixel row with one 8-byte store: a warp writes whole
//     256-byte runs of each of the chunk's 8 rows.  Every row of a plane
//     starts on 8 bytes, so one store path serves every pitch (rows of
//     8, 40 or 488 bytes alike).  A reduced chunk (the size is the
//     component's, so warp-uniform) runs its s x s transform and stores
//     s rows of s bytes a lane, aligned to s as its plane is.
// Per block a lane issues 1,118 SASS instructions, nearly all integer (16
// transforms, the dequantise, the range limit; counted from the first
// coefficient load to the last pixel store by chip_smoke.py phase 34b,
// nvcc 12.8), 37.27 warp instructions a block on the b4 camera batch: an
// issue floor of 0.042 ms on an H100 at 1980 MHz, below the byte bound.
// The CTA's shape, timed against others by tools/idct_variants.py on an
// H100 (the b4 layout, one call): 3 or 4 consumers and 2 stages a ring
// are within 2 % of it, 8 consumers (2 CTAs an SM) and 4 stages (the
// ring's shared memory then leaves 2 CTAs an SM) 14-21 % slower.

#include <cstdint>
#include <cuda_runtime.h>

#include "conv3x3.cuh"  // mbarrier, TMA and tensor-map helpers

namespace {

// Blocks a chunk, a warp's lanes: kernels/jpeg_idct.py:CHUNK_BLOCKS
// passes the same number and the launch refuses any other.
constexpr int kChunk = 32;
// The CTA's shape, fixed here; tools/idct_variants.py builds others with
// -D to time them against this one.
#ifndef JPEG_IDCT_CONSUMERS
#define JPEG_IDCT_CONSUMERS 5
#endif
#ifndef JPEG_IDCT_MIN_CTAS
#define JPEG_IDCT_MIN_CTAS 3
#endif
#ifndef JPEG_IDCT_RING
#define JPEG_IDCT_RING 3
#endif
constexpr int kConsumers = JPEG_IDCT_CONSUMERS;  // consumer warps a CTA
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kMinCtas = JPEG_IDCT_MIN_CTAS;     // CTAs an SM: <= 113 regs
constexpr int kStages = JPEG_IDCT_RING * kConsumers;  // a ring a consumer
constexpr int kBoxBlocks = 8;                // blocks a TMA box: 1024 B
constexpr int kStageBytes = kChunk * 128;
constexpr int kChunkWords = 5;               // a chunk table row
constexpr int kCompWords = 6;                // a component row
// Dynamic shared memory: the stages (1024-byte aligned for the swizzle),
// the quant rows, each stage's (output offset, pitch, count), the full
// and empty barriers, the component each quant slot holds; + 1 KB slack
// to align the start.
constexpr int kSmemBytes = 1024 + kStages * (kStageBytes + 256 + 16 + 16) +
                           kStages * 4;

using u32 = uint32_t;

// ---- block arithmetic (kept free of device intrinsics but the pack) ----
constexpr int FIX_0_298631336 = 2446;
constexpr int FIX_0_390180644 = 3196;
constexpr int FIX_0_541196100 = 4433;
constexpr int FIX_0_765366865 = 6270;
constexpr int FIX_0_899976223 = 7373;
constexpr int FIX_1_175875602 = 9633;
constexpr int FIX_1_501321110 = 12299;
constexpr int FIX_1_847759065 = 15137;
constexpr int FIX_1_961570560 = 16069;
constexpr int FIX_2_053119869 = 16819;
constexpr int FIX_2_562915447 = 20995;
constexpr int FIX_3_072711026 = 25172;
// The row pass's constant on the (v0 +- v4) << 13 terms: DESCALE's
// 1 << 17, and 512 << 18 for the range limit's sign flip.
constexpr u32 kRowBias = (1u << 17) + (512u << 18);

__device__ __forceinline__ u32 mul(u32 a, int c) {
  return a * static_cast<u32>(c);
}

// The 1-D islow transform of jidctint.c, the 8 sums before the shift,
// each with `bias` added.
__device__ __forceinline__ void islow(const u32 (&v)[8], u32 bias,
                                      u32 (&o)[8]) {
  u32 z2 = v[2], z3 = v[6];
  u32 z1 = mul(z2 + z3, FIX_0_541196100);
  const u32 tmp2 = z1 + mul(z3, -FIX_1_847759065);
  const u32 tmp3 = z1 + mul(z2, FIX_0_765366865);
  const u32 tmp0e = ((v[0] + v[4]) << 13) + bias;
  const u32 tmp1e = ((v[0] - v[4]) << 13) + bias;
  const u32 tmp10 = tmp0e + tmp3, tmp13 = tmp0e - tmp3;
  const u32 tmp11 = tmp1e + tmp2, tmp12 = tmp1e - tmp2;

  u32 t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  u32 z4 = t1 + t3;
  const u32 z5 = mul(z3 + z4, FIX_1_175875602);
  t0 = mul(t0, FIX_0_298631336);
  t1 = mul(t1, FIX_2_053119869);
  t2 = mul(t2, FIX_3_072711026);
  t3 = mul(t3, FIX_1_501321110);
  z1 = mul(z1, -FIX_0_899976223);
  z2 = mul(z2, -FIX_2_562915447);
  z3 = mul(z3, -FIX_1_961570560) + z5;
  z4 = mul(z4, -FIX_0_390180644) + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;

  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

// (b << 8 | a) saturated to u8 each, above `hi` shifted left 16:
// cvt.pack.sat.u8.s32.b32 d, b, a, hi.
__device__ __forceinline__ u32 pack_sat_u8(int a, int b, u32 hi) {
  u32 d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(b), "r"(a), "r"(hi));
  return d;
}

// A row pass's sum to the range limit's index less 384 (see the top).
__device__ __forceinline__ int limit_index(u32 x) {
  return static_cast<int>((x >> 18) & 1023u) - 384;
}

// The same for a sum descaled by `shift`, the bias DESCALE's rounding
// constant and 512 << shift, as at the top.
__device__ __forceinline__ u32 limit_bias(int shift) {
  return (1u << (shift - 1)) + (512u << shift);
}
__device__ __forceinline__ int limit_at(u32 x, int shift) {
  return static_cast<int>((x >> shift) & 1023u) - 384;
}

// A block's coefficients dequantised, x[k][c] = row k, column c (as
// idct_block loads them).
template <class Rows>
__device__ __forceinline__ void dequantise(const Rows& row, const int4* q,
                                           u32 (&x)[8][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 r = row(k);
    const int4 qa = q[2 * k], qb = q[2 * k + 1];
    const u32 w[4] = {r.x, r.y, r.z, r.w};
    const int qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u32 lo = static_cast<u32>(static_cast<int>(
          static_cast<int16_t>(w[j] & 0xFFFFu)));
      const u32 hi = static_cast<u32>(static_cast<int32_t>(w[j]) >> 16);
      x[k][2 * j] = lo * static_cast<u32>(qs[2 * j]);
      x[k][2 * j + 1] = hi * static_cast<u32>(qs[2 * j + 1]);
    }
  }
}

constexpr int FIX_0_211164243 = 1730;
constexpr int FIX_0_509795579 = 4176;
constexpr int FIX_0_601344887 = 4926;
constexpr int FIX_0_720959822 = 5906;
constexpr int FIX_0_850430095 = 6967;
constexpr int FIX_1_061594337 = 8697;
constexpr int FIX_1_272758580 = 10426;
constexpr int FIX_1_451774981 = 11893;
constexpr int FIX_2_172734803 = 17799;
constexpr int FIX_3_624509785 = 29692;

// jpeg_idct_4x4's 1-D transform (v[4] unread): the 4 sums before the
// shift, each with `bias` added.
__device__ __forceinline__ void red4(const u32 (&v)[8], u32 bias,
                                     u32 (&o)[4]) {
  const u32 tmp0 = (v[0] << 14) + bias;
  const u32 tmp2 = mul(v[2], FIX_1_847759065) + mul(v[6], -FIX_0_765366865);
  const u32 tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
  const u32 t0 = mul(v[7], -FIX_0_211164243) + mul(v[5], FIX_1_451774981) +
                 mul(v[3], -FIX_2_172734803) + mul(v[1], FIX_1_061594337);
  const u32 t2 = mul(v[7], -FIX_0_509795579) + mul(v[5], -FIX_0_601344887) +
                 mul(v[3], FIX_0_899976223) + mul(v[1], FIX_2_562915447);
  o[0] = tmp10 + t2;
  o[3] = tmp10 - t2;
  o[1] = tmp12 + t0;
  o[2] = tmp12 - t0;
}

// jpeg_idct_2x2's 1-D transform (v[0, 1, 3, 5, 7] read), as red4.
__device__ __forceinline__ void red2(const u32 (&v)[8], u32 bias,
                                     u32 (&o)[2]) {
  const u32 tmp10 = (v[0] << 15) + bias;
  const u32 t0 = mul(v[7], -FIX_0_720959822) + mul(v[5], FIX_0_850430095) +
                 mul(v[3], -FIX_1_272758580) + mul(v[1], FIX_3_624509785);
  o[0] = tmp10 + t0;
  o[1] = tmp10 - t0;
}

// A reduced block, S = 4 or 2: the column pass, then the row pass to
// pixels; row r comes back in px[r], S bytes from the low end.
template <int S, class Rows>
__device__ __forceinline__ void idct_block_reduced(const Rows& row,
                                                   const int4* q,
                                                   u32 (&px)[4]) {
  constexpr int kExtra = S == 4 ? 1 : 2;     // bits more a pass than islow
  constexpr int kShift1 = 11 + kExtra, kShift2 = 18 + kExtra;
  u32 x[8][8];
  dequantise(row, q, x);
  u32 ws[S][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {              // down each column
    if (c == 4 || (S == 2 && (c == 2 || c == 6))) {
#pragma unroll
      for (int r = 0; r < S; ++r) ws[r][c] = 0u;   // never read
      continue;
    }
    u32 v[8], o[S];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = x[k][c];
    if constexpr (S == 4)
      red4(v, 1u << (kShift1 - 1), o);
    else
      red2(v, 1u << (kShift1 - 1), o);
#pragma unroll
    for (int r = 0; r < S; ++r)
      ws[r][c] = static_cast<u32>(static_cast<int32_t>(o[r]) >> kShift1);
  }
#pragma unroll
  for (int r = 0; r < S; ++r) {              // along each row
    u32 o[S];
    if constexpr (S == 4) {
      red4(ws[r], limit_bias(kShift2), o);
      px[r] = pack_sat_u8(limit_at(o[0], kShift2), limit_at(o[1], kShift2),
                          pack_sat_u8(limit_at(o[2], kShift2),
                                      limit_at(o[3], kShift2), 0));
    } else {
      red2(ws[r], limit_bias(kShift2), o);
      px[r] = pack_sat_u8(limit_at(o[0], kShift2), limit_at(o[1], kShift2),
                          0);
    }
  }
}

// jpeg_idct_1x1: the DC term, dequantised, DESCALEd by 3.
__device__ __forceinline__ u32 idct_1x1(int16_t dc, int q) {
  const u32 x = static_cast<u32>(static_cast<int>(dc)) * static_cast<u32>(q);
  return pack_sat_u8(limit_at(x + limit_bias(3), 3), 0, 0) & 255u;
}

// One 8x8 block: `row(k)` gives coefficient row k as 8 int16 (a uint4),
// `q` the component's 64 quant steps (16 int4, natural order); the 8 pixel
// rows come back as 8 bytes each.
template <class Rows>
__device__ __forceinline__ void idct_block(const Rows& row, const int4* q,
                                           uint2 (&px)[8]) {
  u32 x[8][8];
  dequantise(row, q, x);
#pragma unroll
  for (int c = 0; c < 8; ++c) {              // down each column
    u32 v[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = x[k][c];
    islow(v, 1u << 10, o);                   // DESCALE by 11
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k][c] = static_cast<u32>(static_cast<int32_t>(o[k]) >> 11);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {              // along each row
    u32 o[8];
    islow(x[r], kRowBias, o);
    px[r].x = pack_sat_u8(limit_index(o[0]), limit_index(o[1]),
                          pack_sat_u8(limit_index(o[2]), limit_index(o[3]),
                                      0));
    px[r].y = pack_sat_u8(limit_index(o[4]), limit_index(o[5]),
                          pack_sat_u8(limit_index(o[6]), limit_index(o[7]),
                                      0));
  }
}
// ---- end of block arithmetic ----

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(conv3x3::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(conv3x3::smem_addr(bar))
      : "memory");
}

// A block's coefficient rows in a swizzled stage: 16-byte chunk k of the
// block's 128-byte row sits at chunk k ^ (row & 7) of it.
struct SwizzledRows {
  const uint4* p;
  int swz;
  __device__ __forceinline__ uint4 operator()(int k) const {
    return p[k ^ swz];
  }
};

// A chunk as the producer issues it: its first block, component, count
// (0 past the last chunk) and scaled size, and its first block's pixel
// row 0 in the output and the plane's pitch.
struct Chunk {
  int first, comp, count, size, pitch;
  long long out;
};

__device__ __forceinline__ Chunk load_chunk(const int32_t* __restrict__ chunks,
                                            const int32_t* __restrict__ comps,
                                            int n_chunks, int c) {
  Chunk k{0, 0, 0, 0, 0, 0};
  if (c >= n_chunks) return k;
  const int32_t* ch = chunks + static_cast<long long>(c) * kChunkWords;
  k.first = __ldg(ch);
  k.comp = __ldg(ch + 1);
  const int row = __ldg(ch + 2), col = __ldg(ch + 3);
  k.count = __ldg(ch + 4);
  const int32_t* cp = comps + kCompWords * k.comp;
  k.size = __ldg(cp + 3);
  k.pitch = __ldg(cp + 2) * k.size;
  const long long start =
      static_cast<long long>(static_cast<uint32_t>(__ldg(cp + 4))) |
      static_cast<long long>(__ldg(cp + 5)) << 32;
  k.out = start + static_cast<long long>(row) * k.size * k.pitch +
          static_cast<long long>(col) * k.size;
  return k;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
    jpeg_idct_kernel(const __grid_constant__ CUtensorMap coef_map,
                     const int32_t* __restrict__ quant,
                     const int32_t* __restrict__ comps,
                     const int32_t* __restrict__ chunks, int n_chunks,
                     uint8_t* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  // Offsets from smem_raw keep the pointers in the shared window, so the
  // compiler emits LDS / STS and not generic loads.
  uint8_t* base =
      smem_raw + ((1024u - (conv3x3::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = base;
  int4* qrows = reinterpret_cast<int4*>(base + kStages * kStageBytes);
  longlong2* where = reinterpret_cast<longlong2*>(qrows + kStages * 16);
  uint64_t* full = reinterpret_cast<uint64_t*>(where + kStages);
  uint64_t* empty = full + kStages;
  int* slot_comp = reinterpret_cast<int*>(empty + kStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      conv3x3::mbar_init(&full[s], 1);
      conv3x3::mbar_init(&empty[s], 1);
      slot_comp[s] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {                  // the producer warp
    // Its lanes read the rows of the next 32 chunks, one a lane, a batch
    // ahead of lane 0, which issues each chunk's copies in turn.
    Chunk next = load_chunk(chunks, comps, n_chunks, blockIdx.x + lane *
                                                         gridDim.x);
    for (int ahead = 0;; ahead += 32) {
      const Chunk cur = next;
      next = load_chunk(chunks, comps, n_chunks,
                        blockIdx.x + (ahead + 32 + lane) * gridDim.x);
      for (int j = 0; j < 32; ++j) {
        const int count = __shfl_sync(0xFFFFFFFFu, cur.count, j);
        if (count == 0) return;              // past the last chunk
        const int first = __shfl_sync(0xFFFFFFFFu, cur.first, j);
        const int comp = __shfl_sync(0xFFFFFFFFu, cur.comp, j);
        const long long off = __shfl_sync(0xFFFFFFFFu, cur.out, j);
        const int pitch = __shfl_sync(0xFFFFFFFFu, cur.pitch, j);
        const int size = __shfl_sync(0xFFFFFFFFu, cur.size, j);
        const int i = ahead + j, s = i % kStages, round = i / kStages;
        if (lane == 0) {
          if (round > 0) conv3x3::mbar_wait(&empty[s], (round - 1) & 1);
          where[s] = make_longlong2(
              off, static_cast<long long>(pitch) << 32 | size << 8 | count);
          const int boxes = (count + kBoxBlocks - 1) / kBoxBlocks;
          const bool load_q = slot_comp[s] != comp;
          conv3x3::mbar_expect_tx(
              &full[s], boxes * kBoxBlocks * 128 + (load_q ? 256 : 0));
          for (int b = 0; b < boxes; ++b)
            conv3x3::tma_load_2d(
                stages + s * kStageBytes + b * kBoxBlocks * 128, &coef_map,
                &full[s], 0, first + b * kBoxBlocks);
          if (load_q) {
            bulk_load(qrows + s * 16, quant + 64LL * comp, 256, &full[s]);
            slot_comp[s] = comp;
          }
        }
        __syncwarp();
      }
    }
  }

  int i = warp;
  for (int c = blockIdx.x + warp * gridDim.x; c < n_chunks;
       c += kConsumers * gridDim.x, i += kConsumers) {
    const int s = i % kStages;
    conv3x3::mbar_wait(&full[s], (i / kStages) & 1);
    const longlong2 w = where[s];
    const int count = static_cast<int>(w.y & 0xFF);
    const int size = static_cast<int>((w.y >> 8) & 0xFF);
    const long long pitch = w.y >> 32;
    const SwizzledRows rows{
        reinterpret_cast<const uint4*>(stages + s * kStageBytes) + lane * 8,
        lane & 7};
    if (size == 8) {
      uint2 px[8];
      if (lane < count) idct_block(rows, qrows + s * 16, px);
      __syncwarp();
      if (lane == 0) conv3x3::mbar_arrive(&empty[s]);
      if (lane < count) {
        uint8_t* dst = out + w.x + lane * 8;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          *reinterpret_cast<uint2*>(dst + r * pitch) = px[r];
      }
      continue;
    }
    u32 px[4];
    if (lane < count) {
      if (size == 4)
        idct_block_reduced<4>(rows, qrows + s * 16, px);
      else if (size == 2)
        idct_block_reduced<2>(rows, qrows + s * 16, px);
      else   // the DC term: chunk word 0 of the block's swizzled row 0
        px[0] = idct_1x1(static_cast<int16_t>(rows(0).x & 0xFFFFu),
                         qrows[s * 16].x);
    }
    __syncwarp();
    if (lane == 0) conv3x3::mbar_arrive(&empty[s]);
    if (lane < count) {
      uint8_t* dst = out + w.x + lane * size;
      if (size == 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<u32*>(dst + r * pitch) = px[r];
      } else if (size == 2) {
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(px[0]);
        *reinterpret_cast<uint16_t*>(dst + pitch) =
            static_cast<uint16_t>(px[1]);
      } else {
        *dst = static_cast<uint8_t>(px[0]);
      }
    }
  }
}

}  // namespace

// One launch over every block of a batch: coefs (total_blocks * 64)
// int16 and out (the planes' bytes) u8 on the card, 16-byte aligned;
// quant (n_comp, 64) int32; comps (n_comp, 6) int32: first block, block
// rows, block columns, scaled size (8, 4, 2 or 1), the plane's start in
// out (low, high word), the components in order and tiling
// [0, total_blocks); chunks (n_chunks, 5) int32
// (kernels/jpeg_idct.py:idct_chunks), each of at most chunk_blocks
// blocks, which must be kChunk.  Returns a cudaError_t (0 on success) or
// conv3x3's tensor-map error codes.
extern "C" int jpeg_idct_launch(const void* coefs, const void* quant,
                                const void* comps, const void* chunks,
                                int n_chunks, int chunk_blocks,
                                long long total_blocks, void* out,
                                void* stream) {
  if (chunk_blocks != kChunk || total_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total_blocks <= 0 || n_chunks <= 0) return 0;
  CUtensorMap coef_map;
  const cuuint64_t dims[2] = {64, static_cast<cuuint64_t>(total_blocks)};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, kBoxBlocks};
  int err = conv3x3::make_map(&coef_map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2,
                              coefs, dims, strides, box,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      jpeg_idct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  int device = 0, sms = 0, per_sm = 0;
  if (cerr == cudaSuccess) cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cerr == cudaSuccess)
    cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jpeg_idct_kernel, kThreads, kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_chunks < sms * per_sm ? n_chunks : sms * per_sm;
  jpeg_idct_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      coef_map, static_cast<const int32_t*>(quant),
      static_cast<const int32_t*>(comps),
      static_cast<const int32_t*>(chunks), n_chunks,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
