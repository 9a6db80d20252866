// JPEG inverse DCT for Hopper, sm_90a: libjpeg's jpeg_idct_islow
// (jidctint.c) over every 8x8 block of a batch of decoded JPEGs, in one
// launch.  No TPU kernel is replaced: the JAX package decodes its camera
// JPEGs on the host with cv2.imread, i.e. libjpeg-turbo's islow IDCT
// (omnihd_scenes_tpu/data/image_loading.py:177); the card's decode runs
// the same integer arithmetic, so its planes equal libjpeg's bit for bit.
// kernels/jpeg_idct.py holds the plain PyTorch version, op for op.
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
// give the same words in any order.  libjpeg's shortcuts for all-zero AC
// columns and rows give what the full transform gives.
//
// Layout: the coefficients of component k (int16, natural order) are
// blocks [start_k, start_k + rows_k * cols_k) of one buffer, row-major on
// its block grid; its plane (u8, rows_k * 8 by cols_k * 8) is the same
// byte range of the output buffer, so a block's pixels sit where its 64
// coefficients sat.
//
// Bound: bytes (int16 coefficients in, u8 planes out, once each) over the
// memory rate; ~700 integer operations a block.  Design: 8 threads a
// block, 32 blocks a CTA.  Thread t reads coefficient row t with one
// 16-byte load (a warp reads 512 contiguous bytes) and dequantises it
// into shared memory; it then runs the column pass on column t and the
// row pass on row t through shared memory, and stores its 8 pixels with
// one 8-byte store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = kThreads / 8;        // 8x8 blocks a CTA

using u32 = uint32_t;

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

__device__ __forceinline__ u32 mul(u32 a, int c) {
  return a * static_cast<u32>(c);
}

// DESCALE(x, n): add 2^(n-1), arithmetic shift right by n.
__device__ __forceinline__ int descale(u32 x, int n) {
  return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// The 1-D islow transform of jidctint.c (the column and the row pass
// share it), each output DESCALEd by `shift`.
__device__ __forceinline__ void islow(const u32 (&v)[8], int shift,
                                      int (&o)[8]) {
  u32 z2 = v[2], z3 = v[6];
  u32 z1 = mul(z2 + z3, FIX_0_541196100);
  const u32 tmp2 = z1 + mul(z3, -FIX_1_847759065);
  const u32 tmp3 = z1 + mul(z2, FIX_0_765366865);
  const u32 tmp0e = (v[0] + v[4]) << 13;
  const u32 tmp1e = (v[0] - v[4]) << 13;
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

  o[0] = descale(tmp10 + t3, shift);
  o[7] = descale(tmp10 - t3, shift);
  o[1] = descale(tmp11 + t2, shift);
  o[6] = descale(tmp11 - t2, shift);
  o[2] = descale(tmp12 + t1, shift);
  o[5] = descale(tmp12 - t1, shift);
  o[3] = descale(tmp13 + t0, shift);
  o[4] = descale(tmp13 - t0, shift);
}

// IDCT_range_limit(cinfo)[x & RANGE_MASK] for 8-bit samples.
__device__ __forceinline__ u32 range_limit(int x) {
  const int s = ((x & 1023) ^ 512) - 512;
  return static_cast<u32>(min(max(s + 128, 0), 255));
}

__global__ void __launch_bounds__(kThreads)
    jpeg_idct_kernel(const int16_t* __restrict__ coefs,
                     const int32_t* __restrict__ quant,
                     const long long* __restrict__ comps, int n_comp,
                     long long total_blocks, uint8_t* __restrict__ out) {
  __shared__ int32_t ws[kBlocks][2][8][9];
  const int t = threadIdx.x & 7, slot = threadIdx.x >> 3;
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const long long g = static_cast<long long>(blockIdx.x) * kBlocks + slot;
  if (g >= total_blocks) return;             // the group's 8 threads alike
  // The component holding block g: the last whose first block is <= g.
  int lo = 0, hi = n_comp - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(comps + 4 * mid) <= g)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long start = __ldg(comps + 4 * lo);
  const int cols = static_cast<int>(__ldg(comps + 4 * lo + 2));
  const long long b = g - start;
  const long long by = b / cols, bx = b - by * cols;

  const int4 raw = __ldg(reinterpret_cast<const int4*>(coefs + g * 64) + t);
  const int16_t* c = reinterpret_cast<const int16_t*>(&raw);
  const int4* q4 = reinterpret_cast<const int4*>(quant + lo * 64 + t * 8);
  const int4 qa = __ldg(q4), qb = __ldg(q4 + 1);
  const int q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    ws[slot][0][t][j] = static_cast<int32_t>(
        static_cast<u32>(static_cast<int32_t>(c[j])) * static_cast<u32>(q[j]));
  __syncwarp(group);

  u32 v[8];
  int o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = static_cast<u32>(ws[slot][0][k][t]);
  islow(v, 11, o);                           // CONST_BITS - PASS1_BITS
#pragma unroll
  for (int k = 0; k < 8; ++k) ws[slot][1][k][t] = o[k];
  __syncwarp(group);

#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = static_cast<u32>(ws[slot][1][t][k]);
  islow(v, 18, o);                           // CONST_BITS + PASS1_BITS + 3
  uint2 px;
  px.x = range_limit(o[0]) | range_limit(o[1]) << 8 |
         range_limit(o[2]) << 16 | range_limit(o[3]) << 24;
  px.y = range_limit(o[4]) | range_limit(o[5]) << 8 |
         range_limit(o[6]) << 16 | range_limit(o[7]) << 24;
  uint8_t* row = out + start * 64 + (by * 8 + t) * (cols * 8LL) + bx * 8;
  *reinterpret_cast<uint2*>(row) = px;
}

}  // namespace

// One launch over every block of a batch: coefs (total_blocks * 64)
// int16 and out (total_blocks * 64) u8 on the card, 16-byte aligned;
// quant (n_comp, 64) int32; comps (n_comp, 4) int64: first block, block
// rows, block columns, unused, the components in order and tiling
// [0, total_blocks).  Returns a cudaError_t (0 on success).
extern "C" int jpeg_idct_launch(const void* coefs, const void* quant,
                                const void* comps, int n_comp,
                                long long total_blocks, void* out,
                                void* stream) {
  if (total_blocks <= 0) return 0;
  const long long grid = (total_blocks + kBlocks - 1) / kBlocks;
  if (n_comp <= 0 || grid > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  jpeg_idct_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int32_t*>(quant),
      static_cast<const long long*>(comps), n_comp, total_blocks,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
