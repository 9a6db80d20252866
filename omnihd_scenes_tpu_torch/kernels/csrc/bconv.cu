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
// HBM.  The design is the simple mma.sync m16n8k16 bf16 -> f32 implicit
// GEMM of conv3x3.cuh, with the BatchNorm affine and ReLU fused into the
// store, so the separate BN and ReLU passes of the unfused network never
// touch memory.  The dilation only moves where a tap reads; pixels whose
// tap falls outside the image are zero-filled by the copy.

#include "conv3x3.cuh"

// Returns a CUDA error code.
extern "C" int bconv3x3_forward(const void* x, const void* w,
                                const float* scale, const float* shift,
                                void* out, int n_img, int h, int wd, int c,
                                int co, int dilation, int relu,
                                void* stream) {
  return conv3x3::launch<conv3x3::BF16, __nv_bfloat16>(
      x, w, scale, shift, out, n_img, h, wd, c, co, dilation, relu,
      static_cast<cudaStream_t>(stream));
}
