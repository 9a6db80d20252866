// LSS sampling view transform (forward) for Hopper, sm_90a: one fused kernel
// from the camera geometry to the BEV grid.
//
// Replaces the TPU Pallas kernels of omnihd_scenes_tpu/ops/pallas_splat.py
// together with the index fields they are fed (sample_bev_pallas, :175,
// computes them with _sample_indices at :214):
//   _pass1_kernel (:68) — one-hot MXU dot per image row that gathers image
//                          columns at i* into a (G, nz, fH, NBP, M)
//                          intermediate;
//   _pass2_kernel (:80) — one-hot dot that gathers image rows at j*, selects
//                          the depth bin kd* and sums over the cameras.
// Both were TPU machinery for a gather.  The function is the f32 einsum
// form, omnihd_scenes_tpu/ops/lss_project.py:_einsum_all:
//
//   out[b, y, x, z, :] = sum_n feat[b, n, j, i, :] * depth[b, n, j, i, kd]
//     (j, kd) = pass 2 of camera n at the cell, i = pass 1 at row j
//   A camera adds nothing where j, i or kd is out of range.
//
// Two entry points share one gather core, templated on where the indices
// come from:
//   lss_sample_bev_forward — the main path: the camera geometry (minv, mt
//     per sample and camera, the f32 coordinate tables) in, the indices
//     computed in registers by lss_geom.cuh, identical to the plain
//     version's; one instance also writes the (j, i, kd) it used, for
//     checking;
//   lss_sample_forward — precomputed int32 index fields in (the layouts of
//     kernels/lss_sample.py), for tests that feed adversarial fields.
//
// What bounds it on an H100: device-memory bytes.  The output (B, ny, nx,
// nz, C) is written once (0.315 GB in bf16 at the serving shapes, b4); each
// depth value and C-wide feature row that a contributing cell gathers is
// read, with reuse between neighbouring cells; the geometry is a few KB.
// There are no index fields in memory and no products worth the tensor
// cores (one multiply-add per channel).  What the design does about it:
//   * one block = one contiguous span of the output: (b, one y, a run of x,
//     all nz); its stores are whole 128-byte lines of 16-byte vectors with
//     the evict-first (streaming) policy, so the output does not push feat
//     and depth, which neighbouring cells gather again, out of L2;
//   * indices first: each thread computes its cell's (j, kd, i) for every
//     camera, arithmetic only, and keeps in shared memory the cameras whose
//     indices are in range, in camera order, so out-of-range cameras cost
//     no load and no register later;
//   * then the gathers, latency hidden: a lane group (8 lanes cover a
//     128-byte bf16 row with 16-byte loads, a warp 4 rows per instruction)
//     carries kPasses cells at once and issues the depth value and feature
//     row of each one's first kCamBatch cameras before it sums any; then
//     it accumulates each cell in camera order, with the multiply and the
//     add rounded separately, as the plain version does.  Measured on an
//     H100 (PERF.md): the stores alone take ~0.1 ms at b4 and
//     the index math hides behind them; the gathers are the rest, bound by
//     the loads each SM keeps in flight, so the design spends no register
//     on a camera that does not contribute, and caps registers so that 16
//     blocks (all 2,048 threads of an SM) fit;
//   * the walk goes down kWalkRows BEV rows before it moves along x, so the
//     blocks resident together cover a compact BEV patch whose image
//     footprints overlap in L2.
// Channel counts whose rows are not a multiple of 16 bytes (or a feat not
// 16-byte aligned) take the same core with 2-element vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lss_geom.cuh"

namespace {

// The tiling and the walk: the fastest of the variants timed on an H100
// (PERF.md).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 128;  // cells per block: tile_x * nz
constexpr int kCamBatch = 1;    // cameras a cell loads at once
constexpr int kPasses = 2;      // cells a lane group carries
constexpr int kWalkRows = 16;   // BEV rows walked before x moves
constexpr int kMaxCams = 32;

// Blocks per SM that ptxas must fit registers for: 16 (all 2,048 threads)
// where a lane holds one vector per camera, 12 where it holds more.  The
// gathers are bound by the loads in flight per SM, so occupancy pays more
// than registers per lane.
template <int K>
constexpr int min_blocks() {
  return K == 1 ? 16 : 12;
}

struct Dims {
  int n_batch, n_cams, f_h, f_w, c_ch, d_bins, nz, ny, nx;
  int tile_x, tiles_x;  // x cells per block, blocks along x
  int lpc_log2;         // lanes per cell = 1 << lpc_log2
  int chunks;           // vectors per feature row
  uint32_t solve_x_mask;
};

// ---- where the indices come from -----------------------------------------

struct FieldsSource {
  const int32_t* i_star;   // (B, N, fH, nz, nb_max)
  const int32_t* j_star;   // (B, N, nz, ny * nx)
  const int32_t* kd_star;  // (B, N, nz, ny * nx)
  int nb_max;

  __device__ void prepare(int, const Dims&, float*) const {}

  __device__ void operator()(const float*, int b, int n, int y, int x, int z,
                             const Dims& d, int* j, int* i, int* kd) const {
    const int64_t bn = (int64_t)b * d.n_cams + n;
    const bool sx = (d.solve_x_mask >> n) & 1u;
    const int col = sx ? y : x;
    const int64_t bg = sx ? (int64_t)y * d.nx + x : (int64_t)x * d.ny + y;
    const int64_t cidx = (bn * d.nz + z) * ((int64_t)d.ny * d.nx) + bg;
    *j = __ldg(j_star + cidx);
    *kd = __ldg(kd_star + cidx);
    *i = -1;
    if (*j >= 0 && *j < d.f_h && *kd >= 0 && *kd < d.d_bins)
      *i = __ldg(i_star + ((bn * d.f_h + *j) * d.nz + z) * nb_max + col);
  }
};

struct GeomSource {
  const float* minv;    // (B, N, 3, 3)
  const float* mt;      // (B, N, 3)
  const float* tables;  // ys (fH) | xc (nx) | yc (ny) | zc (nz)
  lss::GeomConsts k;

  // The block's sample: each camera's coefficients into shared memory.
  __device__ void prepare(int b, const Dims& d, float* scratch) const {
    for (int n = threadIdx.x; n < d.n_cams; n += blockDim.x) {
      const int64_t bn = (int64_t)b * d.n_cams + n;
      const lss::CamCoef c = lss::cam_coef(minv + bn * 9, mt + bn * 3,
                                           (d.solve_x_mask >> n) & 1u);
      *reinterpret_cast<lss::CamCoef*>(scratch + n * lss::kCamCoefFloats) = c;
    }
  }

  __device__ void operator()(const float* scratch, int, int n, int y, int x,
                             int z, const Dims& d, int* j, int* i,
                             int* kd) const {
    const lss::CamCoef c =
        *reinterpret_cast<const lss::CamCoef*>(scratch +
                                               n * lss::kCamCoefFloats);
    const float* ys = tables;
    const float xc = __ldg(tables + d.f_h + x);
    const float yc = __ldg(tables + d.f_h + d.nx + y);
    const float zc = __ldg(tables + d.f_h + d.nx + d.ny + z);
    const bool sx = (d.solve_x_mask >> n) & 1u;
    lss::cell_indices(c, sx ? yc : xc, sx ? xc : yc, zc, ys, d.f_h, d.d_bins,
                      k, j, i, kd);
  }
};

// ---- vectors of feature channels ----------------------------------------

template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };

// EV consecutive channels of a feature row, loaded with one instruction.
template <typename InT, int EV>
struct RowVec {
  using R = typename Raw<EV * sizeof(InT)>::T;
  R raw;

  __device__ __forceinline__ void load(const InT* p) {
    raw = __ldg(reinterpret_cast<const R*>(p));
  }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
    if constexpr (sizeof(InT) == 2) {
      const uint32_t word = w[e >> 1];
      return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
    } else {
      return __uint_as_float(w[e]);
    }
  }
};

__device__ __forceinline__ float load_depth(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float load_depth(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Evict-first (streaming) stores: the output is not read again here.
template <typename T>
__device__ __forceinline__ void store(T* p, T v) {
  __stcs(p, v);
}

// EV f32 sums -> EV channels of OutT at p.
template <typename OutT, int EV>
__device__ __forceinline__ void store_row(OutT* p, const float* v) {
  constexpr int kBytes = EV * (int)sizeof(OutT);
  uint32_t w[kBytes / 4];
  if constexpr (sizeof(OutT) == 2) {
#pragma unroll
    for (int e = 0; e < EV / 2; ++e) w[e] = pack_bf16x2(v[2 * e], v[2 * e + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < EV; ++e) w[e] = __float_as_uint(v[e]);
  }
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int s = 0; s < kBytes / 16; ++s)
      store(reinterpret_cast<uint4*>(p) + s,
            make_uint4(w[4 * s], w[4 * s + 1], w[4 * s + 2], w[4 * s + 3]));
  } else if constexpr (kBytes == 8) {
    store(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
  } else {
    store(reinterpret_cast<unsigned int*>(p), w[0]);
  }
}

// ---- the kernel ------------------------------------------------------------

// EV channels per vector, up to K vectors per lane and cell; kDump writes
// the (j, i, kd) of every (cell, camera) to (B, ny, nx, nz, N) int32.
template <class Src, typename InT, typename OutT, int EV, int K, bool kDump>
__global__ void __launch_bounds__(kThreads, min_blocks<K>())
lss_sample_kernel(Src src, const InT* __restrict__ feat,
                  const InT* __restrict__ depth, OutT* __restrict__ out,
                  int32_t* __restrict__ dump_j, int32_t* __restrict__ dump_i,
                  int32_t* __restrict__ dump_kd, Dims d) {
  extern __shared__ int32_t smem[];
  // Per cell, its contributing cameras in camera order: [k][kMaxCells].
  int32_t* s_pix = smem;                            // pixel (b, n, j, i)
  int32_t* s_kd = smem + d.n_cams * kMaxCells;      // depth bin
  int32_t* s_count = s_kd + d.n_cams * kMaxCells;   // [kMaxCells]
  float* scratch = reinterpret_cast<float*>(s_count + kMaxCells);

  // The walk: per sample, groups of kWalkRows rows; inside a group down y
  // first, then along x.
  const int per_b = d.ny * d.tiles_x;
  const int b = blockIdx.x / per_b;
  const int r = blockIdx.x - b * per_b;
  const int grp = r / (kWalkRows * d.tiles_x);
  const int y0 = grp * kWalkRows;
  const int rows = min(kWalkRows, d.ny - y0);
  const int w = r - grp * kWalkRows * d.tiles_x;
  const int y = y0 + w % rows;
  const int x0 = (w / rows) * d.tile_x;
  const int cells = min(d.tile_x, d.nx - x0) * d.nz;
  const int64_t cell0 = (((int64_t)b * d.ny + y) * d.nx + x0) * d.nz;

  src.prepare(b, d, scratch);
  __syncthreads();

  // 1. Indices, no loads of data: a thread takes whole cells and walks the
  // cameras in order, keeping the ones whose (j, i, kd) are in range.
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const int xi = c / d.nz;
    const int z = c - xi * d.nz;
    int count = 0;
    for (int n = 0; n < d.n_cams; ++n) {
      int j, i, kd;
      src(scratch, b, n, y, x0 + xi, z, d, &j, &i, &kd);
      if constexpr (kDump) {
        const int64_t at = (cell0 + c) * d.n_cams + n;
        dump_j[at] = j;
        dump_i[at] = i;
        dump_kd[at] = kd;
      }
      if (j >= 0 && j < d.f_h && kd >= 0 && kd < d.d_bins && i >= 0 &&
          i < d.f_w) {
        s_pix[count * kMaxCells + c] =
            ((b * d.n_cams + n) * d.f_h + j) * d.f_w + i;
        s_kd[count * kMaxCells + c] = kd;
        ++count;
      }
    }
    s_count[c] = count;
  }
  __syncthreads();

  // 2. Gathers: 1 << lpc_log2 lanes per cell, K vectors of EV channels
  // each; a warp carries kPasses cells per lane group, and issues the
  // loads of their first kCamBatch cameras before it sums any.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lpc = 1 << d.lpc_log2;
  const int cpw = 32 >> d.lpc_log2;
  const int stride = kWarps * cpw;
  const int q0 = lane & (lpc - 1);
  const int sub = lane >> d.lpc_log2;
  for (int cw = warp * cpw; cw < cells; cw += stride * kPasses) {
    RowVec<InT, EV> v[kPasses][kCamBatch][K];
    float wgt[kPasses][kCamBatch];
    int cnt[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int c = cw + p * stride + sub;
      cnt[p] = c < cells ? s_count[c] : 0;
#pragma unroll
      for (int t = 0; t < kCamBatch; ++t) {
        if (t < cnt[p]) {
          const int pix = s_pix[t * kMaxCells + c];
          wgt[p][t] = load_depth(depth + (int64_t)pix * d.d_bins +
                                 s_kd[t * kMaxCells + c]);
          const InT* row = feat + (int64_t)pix * d.c_ch;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int q = q0 + k * lpc;
            if (q < d.chunks) v[p][t][k].load(row + q * EV);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int c = cw + p * stride + sub;
      if (c >= cells) continue;
      float acc[K][EV];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[k][e] = 0.f;
      // Camera order, the multiply and the add rounded separately.
#pragma unroll
      for (int t = 0; t < kCamBatch; ++t) {
        if (t < cnt[p]) {
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int e = 0; e < EV; ++e)
              acc[k][e] = __fadd_rn(acc[k][e],
                                    __fmul_rn(v[p][t][k].get(e), wgt[p][t]));
        }
      }
      for (int t = kCamBatch; t < cnt[p]; ++t) {   // cells seen by more
        const int pix = s_pix[t * kMaxCells + c];  // cameras: in turn
        const float wt = load_depth(depth + (int64_t)pix * d.d_bins +
                                    s_kd[t * kMaxCells + c]);
        const InT* row = feat + (int64_t)pix * d.c_ch;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int q = q0 + k * lpc;
          if (q < d.chunks) {
            RowVec<InT, EV> f;
            f.load(row + q * EV);
#pragma unroll
            for (int e = 0; e < EV; ++e)
              acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(f.get(e), wt));
          }
        }
      }
      OutT* dst = out + (cell0 + c) * d.c_ch;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = q0 + k * lpc;
        if (q < d.chunks) store_row<OutT, EV>(dst + q * EV, acc[k]);
      }
    }
  }
}

// ---- launch ------------------------------------------------------------------

enum : int { kBadDtype = 1001, kBadShape = 1002 };

int log2_ceil(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <class Src, typename InT, typename OutT, int EV, int K, bool kDump>
int launch(const Src& src, const void* feat, const void* depth, void* out,
           int32_t* dj, int32_t* di, int32_t* dkd, Dims d,
           cudaStream_t stream) {
  d.chunks = d.c_ch / EV;
  d.lpc_log2 = log2_ceil(std::min(d.chunks, 32));
  if ((d.chunks + (1 << d.lpc_log2) - 1) >> d.lpc_log2 > K) return kBadShape;
  const int64_t blocks = (int64_t)d.n_batch * d.ny * d.tiles_x;
  const size_t smem = (size_t)d.n_cams *
                          (2 * kMaxCells * sizeof(int32_t) +
                           lss::kCamCoefFloats * sizeof(float)) +
                      kMaxCells * sizeof(int32_t);
  lss_sample_kernel<Src, InT, OutT, EV, K, kDump>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          src, static_cast<const InT*>(feat), static_cast<const InT*>(depth),
          static_cast<OutT*>(out), dj, di, dkd, d);
  return (int)cudaGetLastError();
}

// Picks the vector width: 16 bytes where a feature row is a multiple of 16
// bytes and feat is 16-byte aligned, else 2 channels.
template <class Src, typename InT, typename OutT, bool kDump>
int launch_widths(const Src& src, const void* feat, const void* depth,
                  void* out, int32_t* dj, int32_t* di, int32_t* dkd, Dims d,
                  cudaStream_t stream) {
  constexpr int kWide = 16 / (int)sizeof(InT);
  const bool wide = (d.c_ch * (int)sizeof(InT)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  if (!wide)
    return launch<Src, InT, OutT, 2, 4, kDump>(src, feat, depth, out, dj, di,
                                               dkd, d, stream);
  if (d.c_ch / kWide <= 32)
    return launch<Src, InT, OutT, kWide, 1, kDump>(src, feat, depth, out, dj,
                                                   di, dkd, d, stream);
  if constexpr (sizeof(InT) == 4)
    return launch<Src, InT, OutT, kWide, 2, kDump>(src, feat, depth, out, dj,
                                                   di, dkd, d, stream);
  return kBadShape;
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <class Src, bool kDump>
int launch_dtypes(const Src& src, const void* feat, const void* depth,
                  void* out, int32_t* dj, int32_t* di, int32_t* dkd,
                  int in_dtype, int out_dtype, Dims d, cudaStream_t stream) {
  if (d.n_cams < 1 || d.n_cams > kMaxCams || d.nz < 1 || d.nz > kMaxCells ||
      d.c_ch < 2 || d.c_ch % 2 || d.c_ch > 256)
    return kBadShape;
  d.tile_x = std::max(1, kMaxCells / d.nz);
  d.tiles_x = (d.nx + d.tile_x - 1) / d.tile_x;
  if (in_dtype == 1 && out_dtype == 1)
    return launch_widths<Src, __nv_bfloat16, __nv_bfloat16, kDump>(
        src, feat, depth, out, dj, di, dkd, d, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_widths<Src, __nv_bfloat16, float, kDump>(
        src, feat, depth, out, dj, di, dkd, d, stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_widths<Src, float, float, kDump>(src, feat, depth, out, dj,
                                                  di, dkd, d, stream);
  return kBadDtype;
}

Dims make_dims(uint32_t mask, int n_batch, int n_cams, int f_h, int f_w,
               int c_ch, int d_bins, int nz, int ny, int nx) {
  Dims d{};
  d.n_batch = n_batch;
  d.n_cams = n_cams;
  d.f_h = f_h;
  d.f_w = f_w;
  d.c_ch = c_ch;
  d.d_bins = d_bins;
  d.nz = nz;
  d.ny = ny;
  d.nx = nx;
  d.solve_x_mask = mask;
  return d;
}

}  // namespace

// Returns 0, or cudaGetLastError() after the launch, or 1001 (dtype pair),
// 1002 (shape) for what the kernel does not take.

// Fields in: the int32 index fields of kernels/lss_sample.py.
extern "C" int lss_sample_forward(
    const void* feat, const void* depth, const int32_t* i_star,
    const int32_t* j_star, const int32_t* kd_star, void* out, int in_dtype,
    int out_dtype, uint32_t solve_x_mask, int n_batch, int n_cams, int f_h,
    int f_w, int c_ch, int d_bins, int nz, int ny, int nx, int nb_max,
    void* stream) {
  const FieldsSource src{i_star, j_star, kd_star, nb_max};
  return launch_dtypes<FieldsSource, false>(
      src, feat, depth, out, nullptr, nullptr, nullptr, in_dtype, out_dtype,
      make_dims(solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch, d_bins, nz, ny,
                nx),
      static_cast<cudaStream_t>(stream));
}

// Geometry in (the main path): minv (B, N, 3, 3) and mt (B, N, 3) f32, the
// tables ys | xc | yc | zc f32, the constants as GeomConsts.  With dump_j
// not null, the dumping instance also writes (j, i, kd) per (cell, camera)
// to dump_j / dump_i / dump_kd, each (B, ny, nx, nz, N) int32.
extern "C" int lss_sample_bev_forward(
    const void* feat, const void* depth, const float* minv, const float* mt,
    const float* tables, void* out, int32_t* dump_j, int32_t* dump_i,
    int32_t* dump_kd, int in_dtype, int out_dtype, uint32_t solve_x_mask,
    int n_batch, int n_cams, int f_h, int f_w, int c_ch, int d_bins, int nz,
    int ny, int nx, float d_floor, float d0, float inv_dd, float u_scale,
    float v_scale, float w_lim, float h_lim, void* stream) {
  const GeomSource src{minv, mt, tables,
                       lss::GeomConsts{d_floor, d0, inv_dd, u_scale, v_scale,
                                       w_lim, h_lim}};
  const Dims d = make_dims(solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch,
                           d_bins, nz, ny, nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dump_j != nullptr)
    return launch_dtypes<GeomSource, true>(src, feat, depth, out, dump_j,
                                           dump_i, dump_kd, in_dtype,
                                           out_dtype, d, s);
  return launch_dtypes<GeomSource, false>(src, feat, depth, out, nullptr,
                                          nullptr, nullptr, in_dtype,
                                          out_dtype, d, s);
}
