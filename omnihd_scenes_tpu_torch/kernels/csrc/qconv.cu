// Fused int8 3x3 convolution (stride 1, zero padding 1) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel omnihd_scenes_tpu/ops/qconv.py:_kernel
// (:48): s8 activations and s8 per-output-channel weights, summed exactly
// in s32 over the 9 taps, then the epilogue acc * scale + shift (+ ReLU)
// in f32 before the single store (bf16 on the serving path, f32 for
// checks).  The Pallas kernel pads and stacks three dx-shifted copies of
// the input in HBM, because Mosaic needs 8-aligned dynamic sublane
// offsets; here the kernel reads the NHWC activation in place and the
// TMA unit zero-fills the border (conv3x3.cuh).
//
// What bounds it on an H100: tensor-core operations.  The int8 PTQ tier
// sends every eligible conv (3x3, stride 1, C and Co multiples of 128)
// here: 36 layers and 16.4 TOP per batch-4 request of the serving
// configuration (ResNet layer2-4, FPN + FPNC, DepthNet, BEV encoder,
// SECOND stages 2-3, fuse; counted from their shapes), at 768-6,144
// operations per byte of s8 input and bf16 output, above the card's ~590
// int8 operations per byte of HBM bandwidth.
// The design is the warp-specialised wgmma (m64nBNk32 s8 -> s32) implicit
// GEMM of conv3x3.cuh, fed by TMA loads of the NHWC activation and the
// OHWI weights through an mbarrier ring, one persistent block per SM; what
// it leaves on the table is listed there.  The weights arrive already in the
// kernel's OHWI layout, packed once when they are frozen or loaded
// (models/quant.py), never per request.
//
// The sum of 9*C products of |v| <= 127 stays below 127^2 * 9 * C
// (1.5e8 at C = 1024), so s32 cannot overflow.  The epilogue rounds the
// conversion, the product and the sum separately, as the plain PyTorch
// version does, so the two agree exactly.

#include "conv3x3.cuh"

// out_dtype: 0 = float32, 1 = bfloat16; (bh, bw) the block's pixel
// rectangle and bn its channel tile (kernels/_conv3x3.py picks them).
// Returns 0 or an error code (conv3x3::launch).
extern "C" int qconv3x3_forward(const void* x8, const void* w8,
                                const float* scale, const float* shift,
                                void* out, int out_dtype, int n_img, int h,
                                int w, int c, int co, int relu, int bh,
                                int bw, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return conv3x3::launch<conv3x3::S8, float>(
        x8, w8, scale, shift, out, n_img, h, w, c, co, 1, relu, bh, bw, bn, s);
  if (out_dtype == 1)
    return conv3x3::launch<conv3x3::S8, __nv_bfloat16>(
        x8, w8, scale, shift, out, n_img, h, w, c, co, 1, relu, bh, bw, bn, s);
  return (int)cudaErrorInvalidValue;
}
