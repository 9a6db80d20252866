// LSS sampling view transform (forward) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel pair in omnihd_scenes_tpu/ops/pallas_splat.py:
//   _pass1_kernel (:68) — one-hot MXU dot per image row that gathers image
//                          columns into a (G, nz, fH, NBP, M) intermediate;
//   _pass2_kernel (:80) — one-hot dot that gathers image rows, selects the
//                          depth bin and accumulates over the cameras of a
//                          group in a VMEM accumulator across grid steps.
// Both were TPU machinery for a gather.  The function is defined by the f32
// einsum form, omnihd_scenes_tpu/ops/lss_project.py:_einsum_all:
//
//   out[b, y, x, z, :] = sum_n feat[b, n, j, i, :] * depth[b, n, j, i, kd]
//     (bb, g) = (y, x) if camera n solves x (front/back) else (x, y)
//     j  = j_star[b, n, z, bb, g]      kd = kd_star[b, n, z, bb, g]
//     i  = i_star[b, n, j, z, bb]      (read at row j, never re-projected)
//   A camera adds nothing where j, i or kd is out of range (kd has no upper
//   bound from the index math, so kd >= D is tested here explicitly).
//
// What bounds it on an H100: device-memory bytes.  Per output cell and
// camera it reads two int32 index words, one i_star word, one depth value
// and one C-wide feature row, then writes the C-wide output row once; there
// are no products worth the tensor cores (one multiply-add per channel).
// The design is a direct gather:
//   * one warp per output cell, lanes over channels, two per lane, so one
//     feature row is one coalesced 128-byte (bf16, C = 64) load;
//   * the warp loops over all cameras and accumulates in f32 registers —
//     the in-block camera loop replaces the TPU's sequential-grid VMEM
//     accumulator, so each cell is written exactly once: no atomics, no
//     second pass, and the pass-1 intermediate (0.8 GB at 6 cameras, b1)
//     never exists;
//   * every camera and both orientations go in one launch, on the output
//     layout (B, ny, nx, nz, C), whose z-collapse into channels_last
//     (B, nz * C, ny, nx) is a free reshape for the BEV encoder.
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn):
// with cameras summed in order this computes exactly what the plain PyTorch
// version does, so the two can be compared without a tolerance for FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPairsPerLane = 4;  // C <= 2 * 32 * 4 = 256 channels

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lss_sample_kernel(const InT* __restrict__ feat, const InT* __restrict__ depth,
                  const int32_t* __restrict__ i_star,
                  const int32_t* __restrict__ j_star,
                  const int32_t* __restrict__ kd_star, OutT* __restrict__ out,
                  uint32_t solve_x_mask, int n_batch, int n_cams, int f_h,
                  int f_w, int c_ch, int d_bins, int nz, int ny, int nx,
                  int nb_max) {
  const int lane = threadIdx.x & 31;
  const int64_t cell =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_cells = (int64_t)n_batch * ny * nx * nz;
  if (cell >= n_cells) return;  // whole warps leave together

  const int z = (int)(cell % nz);
  int64_t rest = cell / nz;
  const int x = (int)(rest % nx);
  rest /= nx;
  const int y = (int)(rest % ny);
  const int b = (int)(rest / ny);
  const int64_t plane = (int64_t)ny * nx;

  float acc[kMaxPairsPerLane][2];
#pragma unroll
  for (int p = 0; p < kMaxPairsPerLane; ++p) {
    acc[p][0] = 0.f;
    acc[p][1] = 0.f;
  }

  for (int n = 0; n < n_cams; ++n) {
    const int64_t bn = (int64_t)b * n_cams + n;
    const bool solve_x = (solve_x_mask >> n) & 1u;
    const int col = solve_x ? y : x;
    const int64_t bg = solve_x ? (int64_t)y * nx + x : (int64_t)x * ny + y;
    const int64_t cidx = (bn * nz + z) * plane + bg;
    const int j = __ldg(j_star + cidx);
    const int kd = __ldg(kd_star + cidx);
    if (j < 0 || j >= f_h || kd < 0 || kd >= d_bins) continue;
    const int i = __ldg(i_star + ((bn * f_h + j) * nz + z) * nb_max + col);
    if (i < 0 || i >= f_w) continue;
    const int64_t pix = (bn * f_h + j) * f_w + i;
    const float w = load_one(depth + pix * d_bins + kd);
    const InT* row = feat + pix * c_ch;
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int c = 2 * (lane + 32 * p);
      if (c < c_ch) {
        const float2 f = load_pair(row + c);
        acc[p][0] = __fadd_rn(acc[p][0], __fmul_rn(f.x, w));
        acc[p][1] = __fadd_rn(acc[p][1], __fmul_rn(f.y, w));
      }
    }
  }

  OutT* dst = out + cell * c_ch;
#pragma unroll
  for (int p = 0; p < kMaxPairsPerLane; ++p) {
    const int c = 2 * (lane + 32 * p);
    if (c < c_ch) store_pair(dst + c, acc[p][0], acc[p][1]);
  }
}

template <typename InT, typename OutT>
void launch(const void* feat, const void* depth, const int32_t* i_star,
            const int32_t* j_star, const int32_t* kd_star, void* out,
            uint32_t mask, int n_batch, int n_cams, int f_h, int f_w, int c_ch,
            int d_bins, int nz, int ny, int nx, int nb_max,
            cudaStream_t stream) {
  const int64_t n_cells = (int64_t)n_batch * ny * nx * nz;
  const unsigned blocks =
      (unsigned)((n_cells + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lss_sample_kernel<InT, OutT><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const InT*>(feat), static_cast<const InT*>(depth), i_star,
      j_star, kd_star, static_cast<OutT*>(out), mask, n_batch, n_cams, f_h,
      f_w, c_ch, d_bins, nz, ny, nx, nb_max);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported dtype pair).
extern "C" int lss_sample_forward(
    const void* feat, const void* depth, const int32_t* i_star,
    const int32_t* j_star, const int32_t* kd_star, void* out, int in_dtype,
    int out_dtype, uint32_t solve_x_mask, int n_batch, int n_cams, int f_h,
    int f_w, int c_ch, int d_bins, int nz, int ny, int nx, int nb_max,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(feat, depth, i_star, j_star, kd_star,
                                         out, solve_x_mask, n_batch, n_cams,
                                         f_h, f_w, c_ch, d_bins, nz, ny, nx,
                                         nb_max, s);
  } else if (in_dtype == 1 && out_dtype == 0) {
    launch<__nv_bfloat16, float>(feat, depth, i_star, j_star, kd_star, out,
                                 solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch,
                                 d_bins, nz, ny, nx, nb_max, s);
  } else if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float>(feat, depth, i_star, j_star, kd_star, out,
                         solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch, d_bins,
                         nz, ny, nx, nb_max, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
