"""Fused bf16 3x3 dilated convolution: the CUDA kernel's wrapper, its plain
PyTorch version and its launch count.

``bconv3x3(x, w, scale, shift, relu=, dilation=d)`` computes, for x
(N, C, H, W) and w (Co, C, 3, 3) in bf16 (stride 1, taps at {0, d, 2d},
zero padding d), the conv summed in f32, then ``y * scale + shift`` and
an optional ReLU, stored as an (N, Co, H, W) bf16 channels_last tensor.
It is ``omnihd_scenes_tpu/ops/bconv.py:bconv3x3`` in PyTorch's layouts
(the JAX function takes NHWC / HWIO).  No model calls it, as in the JAX
package; this module is its entry point.  The CUDA source is
``csrc/bconv.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from omnihd_scenes_tpu_torch.kernels._conv3x3 import (check_kernel_args,
                                                       check_shapes, empty_out,
                                                       launch_args,
                                                       raise_on_error)


def _affine_args(w, scale, shift):
    co = w.shape[0]
    if scale is None:
        scale = torch.ones(co, dtype=torch.float32, device=w.device)
    if shift is None:
        shift = torch.zeros(co, dtype=torch.float32, device=w.device)
    return scale, shift


def bconv3x3_reference(x, w, scale=None, shift=None, *, relu: bool = True,
                       dilation: int = 1) -> torch.Tensor:
    """Plain version: an f32 conv of the bf16-rounded inputs with TF32 off
    (state the precision, not the global default), then the affine, the
    ReLU and the bf16 cast."""
    scale, shift = _affine_args(w, scale, shift)
    d = int(dilation)
    xf = x.to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float()
    if x.device.type == 'cuda':
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            y = F.conv2d(xf, wf, padding=d, dilation=d)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    else:
        y = F.conv2d(xf, wf, padding=d, dilation=d)
    y = y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    if relu:
        y = y.clamp_min(0.0)
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def bconv3x3(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None, *,
             relu: bool = True, dilation: int = 1) -> torch.Tensor:
    """Fused bf16 3x3 conv (dilation d) + per-channel affine (+ ReLU).

    ``scale`` / ``shift`` are (Co,) f32, ones / zeros when None.  A CPU
    tensor goes to :func:`bconv3x3_reference`; a CUDA tensor launches the
    kernel (bf16 x and w channels_last, C % 64 == 0, Co % 8 == 0) or
    raises.
    """
    scale, shift = _affine_args(w, scale, shift)
    check_shapes('bconv3x3', x, w, scale, shift)
    d = int(dilation)
    if d < 1:
        raise ValueError(f'bconv3x3: dilation must be >= 1, got {dilation}')
    if x.device.type == 'cpu':
        return bconv3x3_reference(x, w, scale, shift, relu=relu, dilation=d)
    if x.device.type != 'cuda':
        raise ValueError(f'no bconv3x3 for device {x.device}')
    check_kernel_args('bconv3x3', x, w, scale, shift, torch.bfloat16)
    n, h, wd, c, co, bh, bw, bn = launch_args(x, w)
    out = empty_out(x, co, torch.bfloat16)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), out.data_ptr(), n, h, wd, c, co, d,
                 int(relu), bh, bw, bn, stream)
    raise_on_error('bconv3x3', err)
    bconv3x3.launches += 1
    return out


bconv3x3.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('bconv').bconv3x3_forward
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
    fn.restype = i32
    return fn
