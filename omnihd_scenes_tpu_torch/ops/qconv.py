"""Symmetric int8 quantization and the float-in/float-out fused conv
(counterpart of ``omnihd_scenes_tpu/ops/qconv.py:135-169``).

The quantizers compute what the JAX ones compute under ``jax.jit``,
which is how every JAX model path runs them, bit for bit: the codes
divide (``x / sx``, ``k / sw``), round half to even and clip to +-127;
the scales multiply by ``float32(1/127)``, because XLA's algebraic
simplifier turns the JAX source's ``/ 127.0`` into that product (eager
JAX divides, and its scales then differ in the last bit for about one
value in twenty).  Weights are in PyTorch's layout:
the output channel is dim 0 (JAX's HWIO kernels keep it last).  The
kernel itself, :func:`qconv3x3`, lives in :mod:`omnihd_scenes_tpu_torch.
kernels.qconv` and is re-exported here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnihd_scenes_tpu_torch.kernels.qconv import (  # noqa: F401
    qconv3x3, qconv3x3_reference)

# float32(1/127) as a Python float: its product with a float32 value rounds
# once to the same float32 whether PyTorch multiplies in f32 or in f64.
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_act(x: torch.Tensor, amax) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor activation quantization -> (x8 int8 in x's layout, sx
    f32 scalar) with ``sx = max(amax, 1e-6) * float32(1/127)``."""
    amax = torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    sx = torch.clamp_min(amax, 1e-6) * INV_127
    x8 = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return x8, sx


def quantize_weights(kernel: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-output-channel weight quantization of an (Co, ...) kernel ->
    (w8 int8 of the same shape and layout, sw (Co,) f32) with
    ``sw = max(max|k[o]| * float32(1/127), 1e-12)``."""
    kf = kernel.float()
    dims = tuple(range(1, kf.dim()))
    sw = torch.clamp_min(kf.abs().amax(dim=dims) * INV_127, 1e-12)
    w8 = torch.clamp(torch.round(kf / sw.view(-1, *(1,) * len(dims))),
                     -127, 127).to(torch.int8)
    return w8, sw


def qconv3x3_bn_relu(x: torch.Tensor, kernel: torch.Tensor, amax,
                     bn_scale: torch.Tensor, bn_shift: torch.Tensor, *,
                     relu: bool = True,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(bn_scale * conv3x3(x, kernel) + bn_shift [+ folded bias])``
    with s8 arithmetic: x (N, C, H, W), kernel (Co, C, 3, 3); returns
    (N, Co, H, W) bf16 channels_last, as the JAX function returns bf16."""
    cl = torch.channels_last
    x8, sx = quantize_act(x, amax)
    w8, sw = quantize_weights(kernel)
    scale = sx * sw * bn_scale.float()
    shift = bn_shift.float()
    if bias is not None:
        shift = shift + bn_scale.float() * bias.float()
    return qconv3x3(x8.contiguous(memory_format=cl),
                    w8.contiguous(memory_format=cl), scale, shift,
                    relu=relu, out_dtype=torch.bfloat16)
