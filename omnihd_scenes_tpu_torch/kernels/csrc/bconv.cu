// Fused bf16 3x3 convolution with dilation (stride 1, zero padding d) for
// Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel omnihd_scenes_tpu/ops/bconv.py:_kernel
// (:41): bf16 inputs and weights, taps at {0, d, 2d}, an f32 accumulator,
// then y * scale + shift (+ ReLU) in f32 and a bf16 store.  The JAX
// package keeps it as a probe that no model calls; here it is the bf16
// sibling of qconv.cu through its own entry point (kernels/bconv.py),
// likewise not wired into a model.
//
// What bounds it on an H100: tensor-core operations.  At the DepthNet /
// ASPP shape it serves in the JAX probe, (24, 256, 136, 240) -> 256, one
// call is 0.92 TFLOP against 0.40 GB of bf16 input and output, ~2,300
// FLOP per byte, far above the ~295 at which bf16 stops being bound by
// HBM.  The design is the warp-specialised wgmma (m64nBNk16 bf16 -> f32)
// implicit GEMM of conv3x3.cuh, with the BatchNorm affine and ReLU fused
// into the store, so the separate BN and ReLU passes of the unfused network
// never touch memory.  The dilation only moves where a tap's TMA box
// starts; elements outside the image are zero-filled by the TMA unit.

#include "conv3x3.cuh"

// (bh, bw) is the block's pixel rectangle and bn its channel tile
// (kernels/_conv3x3.py picks them).  Returns 0 or an error code
// (conv3x3::launch).
extern "C" int bconv3x3_forward(const void* x, const void* w,
                                const float* scale, const float* shift,
                                void* out, int n_img, int h, int wd, int c,
                                int co, int dilation, int relu, int bh,
                                int bw, int bn, void* stream) {
  return conv3x3::launch<conv3x3::BF16, __nv_bfloat16>(
      x, w, scale, shift, out, n_img, h, wd, c, co, dilation, relu, bh, bw,
      bn, static_cast<cudaStream_t>(stream));
}
