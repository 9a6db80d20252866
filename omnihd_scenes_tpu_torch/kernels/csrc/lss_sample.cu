// LSS sampling view transform for Hopper, sm_90a: one fused kernel from the
// camera geometry to the BEV grid, and its backward.
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
//
// The backward, lss_sample_bev_backward, is the gradient for feat and depth
// (the JAX package's is the einsum VJP inside the jax.custom_vjp of
// pallas_splat.py:246-261, not a Pallas kernel).  For each (cell, camera)
// whose indices are in range, the pair's pixel p = (b, n, j, i) gets
//   dfeat[p, :]       += g[cell, :] * depth[p, kd]
//   ddepth[p, kd]     += <g[cell, :], feat[p, :]>
// What bounds it on an H100: device-memory bytes, ~0.56 GB at b4 bf16 (the
// gradient, as large as the forward's output, read once; feat and depth
// read once; d feat and d depth written once).  The design is pixel-major,
// so that every output element is written once, in feat's dtype, from
// sums taken in a fixed order, with no atomics into the outputs and no f32
// scratch of their size:
//   1. count: the forward's block walk and collect_cameras (so the pairs
//      are the forward's by construction) add one per pair to an int32
//      histogram over the B N fH fW pixels (3.1 MB at b4: it stays in L2);
//      the wrapper takes its inclusive prefix sum (torch.cumsum), the end
//      of each pixel's bucket;
//   2. fill: the same walk writes each pair's key, its cell within the
//      sample times D plus kd, into a free slot of its pixel's bucket
//      (slots taken with integer atomics, so in no fixed order; the
//      histogram is left at zero);
//   3. gather: a lane group per pixel (8 lanes and 16-byte vectors per
//      128-byte bf16 row, as the forward) ranks its bucket's keys (each
//      lane counts the keys below its own; keys are unique: a cell meets a
//      pixel at most once), writes them in increasing cell order to a
//      second list, then sums the pairs in that order: the pixel's feature
//      row loaded once, kBatch gradient rows and depth values in flight
//      before any is summed, d feat accumulated in f32 registers with the
//      multiply and the add rounded separately, each pair's dot product
//      reduced across the group with shuffles and added to the pixel's d
//      depth row in shared memory.  The d feat row and the whole d depth
//      row (zeros where no pair fell, and for pixels with an empty bucket)
//      are written once with streaming stores.  Buckets are skewed (far
//      pixels collect many cells along their ray): nothing caps their
//      length; ranking a bucket of L keys costs L^2 / 8 comparisons per
//      lane on keys that sit in L1.
// Measured on an H100 (PERF.md): the gather kernel takes most of the time
// and is held back by each pixel's chain of dependent loads (bucket ends,
// keys, the sorted copy, then the rows), not by the bytes: it keeps most
// of its time with no gradient row read at all, and its speed follows the
// lane groups resident per SM, so variants that carried more pairs or
// pixels per lane group (more registers or serial work) were slower.
// Determinism and the plain version: each pixel belongs to one camera, so
// the plain index_add_ (sequential over its index on the CPU) adds a
// pixel's pairs in increasing cell order too; the f32 d feat is bit-equal
// to it on the same indices.  d depth's dot product is reduced in another
// order than the plain .sum(-1), so it agrees within a tolerance.  Two
// runs give identical bits.
//
// lss_sample_bev_backward_atomic keeps the previous design (one warp per
// cell, f32 atomics into buffers the caller zeroes) as a yardstick that
// chip_smoke.py times beside the new one; no path of the port calls it.

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

// ---- the block's cells and their cameras (forward and backward) ----------

// The block's span of the output: one sample b, one BEV row y, the x run
// from x0, all nz; cells = (x, z) pairs in it, cell0 the first's index.
struct Span {
  int b, y, x0, cells;
  int64_t cell0;
};

// The walk: per sample, groups of kWalkRows rows; inside a group down y
// first, then along x.
__device__ __forceinline__ Span block_span(const Dims& d) {
  const int per_b = d.ny * d.tiles_x;
  Span sp;
  sp.b = blockIdx.x / per_b;
  const int r = blockIdx.x - sp.b * per_b;
  const int grp = r / (kWalkRows * d.tiles_x);
  const int y0 = grp * kWalkRows;
  const int rows = min(kWalkRows, d.ny - y0);
  const int w = r - grp * kWalkRows * d.tiles_x;
  sp.y = y0 + w % rows;
  sp.x0 = (w / rows) * d.tile_x;
  sp.cells = min(d.tile_x, d.nx - sp.x0) * d.nz;
  sp.cell0 = (((int64_t)sp.b * d.ny + sp.y) * d.nx + sp.x0) * d.nz;
  return sp;
}

// A thread takes whole cells and walks the cameras in order, keeping in
// shared memory the ones whose (j, i, kd) are in range: their pixel (b, n,
// j, i) and depth bin, [k][kMaxCells], and their count.  kDump writes every
// camera's (j, i, kd) to (B, ny, nx, nz, N) int32.
template <class Src, bool kDump>
__device__ __forceinline__ void collect_cameras(
    const Src& src, const float* scratch, int b, int y, int x0, int cells,
    int64_t cell0, const Dims& d, int32_t* s_pix, int32_t* s_kd,
    int32_t* s_count, int32_t* dump_j, int32_t* dump_i, int32_t* dump_kd) {
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
  const Span sp = block_span(d);
  const int b = sp.b, y = sp.y, x0 = sp.x0, cells = sp.cells;
  const int64_t cell0 = sp.cell0;

  src.prepare(b, d, scratch);
  __syncthreads();

  // 1. Indices, no loads of data.
  collect_cameras<Src, kDump>(src, scratch, b, y, x0, cells, cell0, d, s_pix,
                              s_kd, s_count, dump_j, dump_i, dump_kd);
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

// Shared memory of a block of the walk (forward and backward): the cells'
// cameras and depth bins, their counts and the cameras' coefficients.
size_t walk_smem(const Dims& d) {
  return (size_t)d.n_cams * (2 * kMaxCells * sizeof(int32_t) +
                             lss::kCamCoefFloats * sizeof(float)) +
         kMaxCells * sizeof(int32_t);
}

template <class Src, typename InT, typename OutT, int EV, int K, bool kDump>
int launch(const Src& src, const void* feat, const void* depth, void* out,
           int32_t* dj, int32_t* di, int32_t* dkd, Dims d,
           cudaStream_t stream) {
  d.chunks = d.c_ch / EV;
  d.lpc_log2 = log2_ceil(std::min(d.chunks, 32));
  if ((d.chunks + (1 << d.lpc_log2) - 1) >> d.lpc_log2 > K) return kBadShape;
  const int64_t blocks = (int64_t)d.n_batch * d.ny * d.tiles_x;
  lss_sample_kernel<Src, InT, OutT, EV, K, kDump>
      <<<(unsigned)blocks, kThreads, walk_smem(d), stream>>>(
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

// What both directions take, and the blocks' x tiling.
bool tile(Dims* d) {
  if (d->n_cams < 1 || d->n_cams > kMaxCams || d->nz < 1 ||
      d->nz > kMaxCells || d->c_ch < 2 || d->c_ch % 2 || d->c_ch > 256)
    return false;
  d->tile_x = std::max(1, kMaxCells / d->nz);
  d->tiles_x = (d->nx + d->tile_x - 1) / d->tile_x;
  return true;
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <class Src, bool kDump>
int launch_dtypes(const Src& src, const void* feat, const void* depth,
                  void* out, int32_t* dj, int32_t* di, int32_t* dkd,
                  int in_dtype, int out_dtype, Dims d, cudaStream_t stream) {
  if (!tile(&d)) return kBadShape;
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

// ---- the backward ------------------------------------------------------------

constexpr int kBatch = 4;  // pairs whose loads a lane group issues at once

// The block's pairs, from the forward's walk: each (cell, camera) in range
// adds one to its pixel's count (kFill false), or takes a slot of its
// pixel's bucket, ends[pix] - 1 downwards, and writes its key there (kFill
// true: the counts go back to zero).  key = cell within the sample * D + kd.
template <class Src, bool kFill>
__global__ void __launch_bounds__(kThreads)
lss_backward_bucket_kernel(Src src, int32_t* __restrict__ counts,
                           const int32_t* __restrict__ ends,
                           int32_t* __restrict__ keys, Dims d) {
  extern __shared__ int32_t smem[];
  int32_t* s_pix = smem;
  int32_t* s_kd = smem + d.n_cams * kMaxCells;
  int32_t* s_count = s_kd + d.n_cams * kMaxCells;
  float* scratch = reinterpret_cast<float*>(s_count + kMaxCells);
  const Span sp = block_span(d);

  src.prepare(sp.b, d, scratch);
  __syncthreads();
  collect_cameras<Src, false>(src, scratch, sp.b, sp.y, sp.x0, sp.cells,
                              sp.cell0, d, s_pix, s_kd, s_count, nullptr,
                              nullptr, nullptr);
  // Each thread reads back only the cells it collected: no barrier.
  const int cell_base =
      (int)(sp.cell0 - (int64_t)sp.b * d.ny * d.nx * d.nz);
  for (int c = threadIdx.x; c < sp.cells; c += kThreads) {
    const int cnt = s_count[c];
    for (int t = 0; t < cnt; ++t) {
      const int pix = s_pix[t * kMaxCells + c];
      if constexpr (kFill) {
        const int slot = __ldg(ends + pix) - atomicSub(counts + pix, 1);
        keys[slot] = (cell_base + c) * d.d_bins + s_kd[t * kMaxCells + c];
      } else {
        atomicAdd(counts + pix, 1);
      }
    }
  }
}

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  __stcs(reinterpret_cast<unsigned short*>(p),
         *reinterpret_cast<const unsigned short*>(&h));
}
__device__ __forceinline__ void store_one(float* p, float v) { __stcs(p, v); }

// grad (B, ny, nx, nz, C), feat (B, N, fH, fW, C), depth (B, N, fH, fW, D)
// in T; ends / keys from the bucket kernels -> dfeat and ddepth in T.  A
// lane group of 1 << lpc_log2 lanes per pixel, EV channels per vector, K
// vectors per lane; a warp's pixels are consecutive, so its d depth rows
// are one contiguous span, staged in shared memory and stored whole.
template <typename T, int EV, int K>
__global__ void __launch_bounds__(kThreads)
lss_backward_gather_kernel(const T* __restrict__ grad,
                           const T* __restrict__ feat,
                           const T* __restrict__ depth,
                           const int32_t* __restrict__ ends,
                           const int32_t* __restrict__ keys,
                           int32_t* sorted, T* __restrict__ dfeat,
                           T* __restrict__ ddepth, Dims d, int n_pix) {
  extern __shared__ float s_dd[];  // [kWarps][pixels per warp][D]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lpc = 1 << d.lpc_log2;
  const int ppw = 32 >> d.lpc_log2;
  const int q0 = lane & (lpc - 1);
  const int sub = lane >> d.lpc_log2;
  const unsigned gmask =
      lpc == 32 ? 0xffffffffu : ((1u << lpc) - 1u) << (sub * lpc);
  const int p0 = (blockIdx.x * kWarps + warp) * ppw;
  if (p0 >= n_pix) return;                 // the whole warp
  const int rows = min(ppw, n_pix - p0);
  float* dd = s_dd + warp * ppw * d.d_bins;
  for (int k = lane; k < ppw * d.d_bins; k += 32) dd[k] = 0.f;
  __syncwarp();

  const int p = p0 + sub;
  if (sub < rows) {
    const int start = p == 0 ? 0 : __ldg(ends + p - 1);
    const int len = __ldg(ends + p) - start;
    float acc[K][EV];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[k][e] = 0.f;
    if (len > 0) {
      RowVec<T, EV> f[K];
      const T* f_row = feat + (int64_t)p * d.c_ch;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = q0 + k * lpc;
        if (q < d.chunks) f[k].load(f_row + q * EV);
      }
      const int per_b = d.n_cams * d.f_h * d.f_w;
      const T* g_base =
          grad + (int64_t)(p / per_b) * d.ny * d.nx * d.nz * d.c_ch;
      const T* w_row = depth + (int64_t)p * d.d_bins;
      float* dd_row = dd + sub * d.d_bins;

      // The bucket in increasing key (= cell) order: each key's rank is
      // the number of keys below it (keys are unique: a cell meets a pixel
      // at most once).
      for (int t = q0; t < len; t += lpc) {
        const int key = __ldg(keys + start + t);
        int rank = 0;
        for (int u = 0; u < len; ++u) rank += __ldg(keys + start + u) < key;
        sorted[start + rank] = key;
      }
      __syncwarp(gmask);

      // The sums in that order, the loads of kBatch pairs issued before
      // any is summed.
      for (int t0 = 0; t0 < len; t0 += kBatch) {
        RowVec<T, EV> g[kBatch][K];
        float w[kBatch];
        int kd[kBatch];
#pragma unroll
        for (int s = 0; s < kBatch; ++s) {
          if (t0 + s < len) {
            const int key = sorted[start + t0 + s];
            const int cell = key / d.d_bins;
            kd[s] = key - cell * d.d_bins;
            w[s] = load_depth(w_row + kd[s]);
            const T* g_row = g_base + (int64_t)cell * d.c_ch;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int q = q0 + k * lpc;
              if (q < d.chunks) g[s][k].load(g_row + q * EV);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < kBatch; ++s) {
          if (t0 + s < len) {
            float dot = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if (q0 + k * lpc < d.chunks) {
#pragma unroll
                for (int e = 0; e < EV; ++e) {
                  const float gv = g[s][k].get(e);
                  acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(gv, w[s]));
                  dot = fmaf(gv, f[k].get(e), dot);
                }
              }
            }
            for (int off = lpc >> 1; off > 0; off >>= 1)
              dot += __shfl_xor_sync(gmask, dot, off);
            if (q0 == 0) dd_row[kd[s]] += dot;
          }
        }
      }
    }
    T* df_row = dfeat + (int64_t)p * d.c_ch;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = q0 + k * lpc;
      if (q < d.chunks) store_row<T, EV>(df_row + q * EV, acc[k]);
    }
  }
  __syncwarp();
  T* out = ddepth + (int64_t)p0 * d.d_bins;
  for (int k = lane; k < rows * d.d_bins; k += 32) store_one(out + k, dd[k]);
}

template <class Src, bool kFill>
int launch_bucket(const Src& src, int32_t* counts, const int32_t* ends,
                  int32_t* keys, const Dims& d, cudaStream_t stream) {
  lss_backward_bucket_kernel<Src, kFill>
      <<<d.n_batch * d.ny * d.tiles_x, kThreads, walk_smem(d), stream>>>(
          src, counts, ends, keys, d);
  return (int)cudaGetLastError();
}

template <typename T, int EV, int K>
int launch_gather(const void* grad, const void* feat, const void* depth,
                  const int32_t* ends, const int32_t* keys, int32_t* sorted,
                  void* dfeat, void* ddepth, Dims d, cudaStream_t stream) {
  d.chunks = d.c_ch / EV;
  d.lpc_log2 = log2_ceil(std::min(d.chunks, 32));
  if ((d.chunks + (1 << d.lpc_log2) - 1) >> d.lpc_log2 > K) return kBadShape;
  const int ppw = 32 >> d.lpc_log2;
  const size_t smem = (size_t)kWarps * ppw * d.d_bins * sizeof(float);
  auto kernel = lss_backward_gather_kernel<T, EV, K>;
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return kBadShape;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_pix = d.n_batch * d.n_cams * d.f_h * d.f_w;
  const int per_block = kWarps * ppw;
  kernel<<<(unsigned)((n_pix + per_block - 1) / per_block), kThreads, smem,
           stream>>>(static_cast<const T*>(grad), static_cast<const T*>(feat),
                     static_cast<const T*>(depth), ends, keys, sorted,
                     static_cast<T*>(dfeat), static_cast<T*>(ddepth), d,
                     n_pix);
  return (int)cudaGetLastError();
}

// The vector width, as the forward picks it: 16 bytes where a row is a
// multiple of 16 bytes and grad and feat are 16-byte aligned, else 2
// channels.
template <typename T>
int launch_gather_widths(const void* grad, const void* feat,
                         const void* depth, const int32_t* ends,
                         const int32_t* keys, int32_t* sorted, void* dfeat,
                         void* ddepth, const Dims& d, cudaStream_t stream) {
  constexpr int kWide = 16 / (int)sizeof(T);
  const bool wide = (d.c_ch * (int)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dfeat) % 16 == 0;
  if (!wide)
    return launch_gather<T, 2, 4>(grad, feat, depth, ends, keys, sorted,
                                  dfeat, ddepth, d, stream);
  if (d.c_ch / kWide <= 32)
    return launch_gather<T, kWide, 1>(grad, feat, depth, ends, keys, sorted,
                                      dfeat, ddepth, d, stream);
  if constexpr (sizeof(T) == 4)
    return launch_gather<T, kWide, 2>(grad, feat, depth, ends, keys, sorted,
                                      dfeat, ddepth, d, stream);
  return kBadShape;
}

// The previous design, kept as chip_smoke.py's yardstick only: grad -> dfeat
// and ddepth f32, zeroed by the caller, added to with atomics; one warp per
// cell.

// Two consecutive channels as f32.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <class Src, typename T>
__global__ void __launch_bounds__(kThreads)
lss_backward_atomic_kernel(Src src, const T* __restrict__ grad,
                           const T* __restrict__ feat,
                           const T* __restrict__ depth,
                           float* __restrict__ dfeat,
                           float* __restrict__ ddepth, Dims d) {
  extern __shared__ int32_t smem[];
  int32_t* s_pix = smem;
  int32_t* s_kd = smem + d.n_cams * kMaxCells;
  int32_t* s_count = s_kd + d.n_cams * kMaxCells;
  float* scratch = reinterpret_cast<float*>(s_count + kMaxCells);
  const Span sp = block_span(d);

  src.prepare(sp.b, d, scratch);
  __syncthreads();
  collect_cameras<Src, false>(src, scratch, sp.b, sp.y, sp.x0, sp.cells,
                              sp.cell0, d, s_pix, s_kd, s_count, nullptr,
                              nullptr, nullptr);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pairs = d.c_ch / 2;
  for (int c = warp; c < sp.cells; c += kWarps) {
    const int cnt = s_count[c];
    const T* g_row = grad + (sp.cell0 + c) * d.c_ch;
    for (int t = 0; t < cnt; ++t) {
      const int64_t pix = s_pix[t * kMaxCells + c];
      const int64_t at = pix * d.d_bins + s_kd[t * kMaxCells + c];
      const float w = load_depth(depth + at);
      const T* f_row = feat + pix * d.c_ch;
      float* df_row = dfeat + pix * d.c_ch;
      float dot = 0.f;
      for (int p = lane; p < pairs; p += 32) {
        const float2 g = load_pair(g_row + 2 * p);
        const float2 f = load_pair(f_row + 2 * p);
        atomicAdd(df_row + 2 * p, g.x * w);
        atomicAdd(df_row + 2 * p + 1, g.y * w);
        dot += g.x * f.x + g.y * f.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) atomicAdd(ddepth + at, dot);
    }
  }
}

template <class Src, typename T>
int launch_atomic(const Src& src, const void* grad, const void* feat,
                  const void* depth, float* dfeat, float* ddepth,
                  const Dims& d, cudaStream_t stream) {
  const int64_t blocks = (int64_t)d.n_batch * d.ny * d.tiles_x;
  lss_backward_atomic_kernel<Src, T>
      <<<(unsigned)blocks, kThreads, walk_smem(d), stream>>>(
          src, static_cast<const T*>(grad), static_cast<const T*>(feat),
          static_cast<const T*>(depth), dfeat, ddepth, d);
  return (int)cudaGetLastError();
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

// The backward (geometry in, as lss_sample_bev_forward), in two calls
// around the wrapper's prefix sum:
//   lss_sample_bev_backward_count zeroes counts (B, N, fH, fW) int32 and
//     counts each pixel's pairs into it;
//   lss_sample_bev_backward takes ends, the inclusive prefix sum of counts,
//     and keys and sorted, int32 lists with room for every pair (B ny nx nz
//     N entries each), and writes every element of dfeat (B, N, fH, fW, C)
//     and ddepth (B, N, fH, fW, D) in dtype from grad (B, ny, nx, nz, C),
//     feat and depth, all in dtype; counts are left at zero.
extern "C" int lss_sample_bev_backward_count(
    const float* minv, const float* mt, const float* tables, int32_t* counts,
    uint32_t solve_x_mask, int n_batch, int n_cams, int f_h, int f_w,
    int c_ch, int d_bins, int nz, int ny, int nx, float d_floor, float d0,
    float inv_dd, float u_scale, float v_scale, float w_lim, float h_lim,
    void* stream) {
  const GeomSource src{minv, mt, tables,
                       lss::GeomConsts{d_floor, d0, inv_dd, u_scale, v_scale,
                                       w_lim, h_lim}};
  Dims d = make_dims(solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch, d_bins,
                     nz, ny, nx);
  if (!tile(&d)) return kBadShape;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      counts, 0, (size_t)n_batch * n_cams * f_h * f_w * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  return launch_bucket<GeomSource, false>(src, counts, nullptr, nullptr, d, s);
}

extern "C" int lss_sample_bev_backward(
    const void* grad, const void* feat, const void* depth, const float* minv,
    const float* mt, const float* tables, int32_t* counts,
    const int32_t* ends, int32_t* keys, int32_t* sorted, void* dfeat,
    void* ddepth, int dtype, uint32_t solve_x_mask, int n_batch, int n_cams,
    int f_h, int f_w, int c_ch, int d_bins, int nz, int ny, int nx,
    float d_floor, float d0, float inv_dd, float u_scale, float v_scale,
    float w_lim, float h_lim, void* stream) {
  if (dtype != 0 && dtype != 1) return kBadDtype;
  const GeomSource src{minv, mt, tables,
                       lss::GeomConsts{d_floor, d0, inv_dd, u_scale, v_scale,
                                       w_lim, h_lim}};
  Dims d = make_dims(solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch, d_bins,
                     nz, ny, nx);
  if (!tile(&d)) return kBadShape;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_bucket<GeomSource, true>(src, counts, ends, keys, d, s);
  if (err != 0) return err;
  if (dtype == 1)
    return launch_gather_widths<__nv_bfloat16>(grad, feat, depth, ends, keys,
                                               sorted, dfeat, ddepth, d, s);
  return launch_gather_widths<float>(grad, feat, depth, ends, keys, sorted,
                                     dfeat, ddepth, d, s);
}

// The previous design (chip_smoke.py's yardstick): as lss_sample_bev_backward
// but into f32 dfeat and ddepth that the caller zeroes, added to with
// atomics.
extern "C" int lss_sample_bev_backward_atomic(
    const void* grad, const void* feat, const void* depth, const float* minv,
    const float* mt, const float* tables, float* dfeat, float* ddepth,
    int dtype, uint32_t solve_x_mask, int n_batch, int n_cams, int f_h,
    int f_w, int c_ch, int d_bins, int nz, int ny, int nx, float d_floor,
    float d0, float inv_dd, float u_scale, float v_scale, float w_lim,
    float h_lim, void* stream) {
  const GeomSource src{minv, mt, tables,
                       lss::GeomConsts{d_floor, d0, inv_dd, u_scale, v_scale,
                                       w_lim, h_lim}};
  Dims d = make_dims(solve_x_mask, n_batch, n_cams, f_h, f_w, c_ch, d_bins,
                     nz, ny, nx);
  if (!tile(&d)) return kBadShape;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_atomic<GeomSource, __nv_bfloat16>(src, grad, feat, depth,
                                                    dfeat, ddepth, d, s);
  if (dtype == 0)
    return launch_atomic<GeomSource, float>(src, grad, feat, depth, dfeat,
                                            ddepth, d, s);
  return kBadDtype;
}
