"""Fused int8 3x3 convolution: the CUDA kernel's wrapper, its plain
PyTorch version and its launch count.

``qconv3x3(x8, w8, scale, shift)`` computes, for x8 (N, C, H, W) int8 and
w8 (Co, C, 3, 3) int8 (stride 1, zero padding 1),

    y[n, o, h, w] = epi(sum_{c, dy, dx} x8[n, c, h+dy-1, w+dx-1] w8[o, c, dy, dx])
    epi(a) = relu?(float32(a) * scale[o] + shift[o])   (each step rounded)

stored in ``out_dtype`` (bf16 on the serving path, f32 for checks) as an
(N, Co, H, W) channels_last tensor.  It is ``omnihd_scenes_tpu/ops/
qconv.py:qconv3x3`` in PyTorch's layouts: the JAX function takes NHWC /
HWIO and always stores bf16.  The CUDA source is ``csrc/qconv.cu``; the
kernel wants x8 and w8 channels_last (NHWC / OHWI in memory), so
``models/quant.py`` keeps frozen weights in that format.
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

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _int_conv3x3(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact integer sum of a 3x3 zero-padded conv as float64
    (N, H, W, Co): nine shifted f64 matrix products, exact while sums stay
    below 2^53 (they stay below 2^31 for int8 operands)."""
    n, c, h, w = x8.shape
    xp = F.pad(x8.permute(0, 2, 3, 1).double(), (0, 0, 1, 1, 1, 1))
    wt = w8.double()
    acc = torch.zeros((n, h, w, w8.shape[0]), dtype=torch.float64,
                      device=x8.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + w] @ wt[:, :, dy, dx].T
    return acc


def qconv3x3_reference(x8, w8, scale, shift, *, relu: bool = True,
                       out_dtype: torch.dtype = torch.bfloat16):
    """Plain version: the f64 integer sum, then the f32 epilogue with the
    product and the sum rounded separately."""
    y = _int_conv3x3(x8, w8).float() * scale + shift
    if relu:
        y = y.clamp_min(0.0)
    return y.to(out_dtype).permute(0, 3, 1, 2)


def qconv3x3(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
             shift: torch.Tensor, *, relu: bool = True,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused s8 3x3 conv + per-channel affine (+ ReLU).

    A CPU tensor goes to :func:`qconv3x3_reference`; a CUDA tensor
    launches the kernel (int8 x8 and w8 channels_last, C % 128 == 0,
    Co % 8 == 0, out_dtype f32 or bf16) or raises.
    """
    check_shapes('qconv3x3', x8, w8, scale, shift)
    if x8.device.type == 'cpu':
        return qconv3x3_reference(x8, w8, scale, shift, relu=relu,
                                  out_dtype=out_dtype)
    if x8.device.type != 'cuda':
        raise ValueError(f'no qconv3x3 for device {x8.device}')
    check_kernel_args('qconv3x3', x8, w8, scale, shift, torch.int8)
    if out_dtype not in _OUT_CODES:
        raise TypeError(f'qconv3x3 kernel stores float32 or bfloat16, not '
                        f'{out_dtype}')
    n, h, w, c, co, bh, bw, bn = launch_args(x8, w8)
    out = empty_out(x8, co, out_dtype)
    fn = _kernel()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        err = fn(x8.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), out.data_ptr(), _OUT_CODES[out_dtype],
                 n, h, w, c, co, int(relu), bh, bw, bn, stream)
    raise_on_error('qconv3x3', err)
    qconv3x3.launches += 1
    return out


qconv3x3.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('qconv').qconv3x3_forward
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
    fn.restype = i32
    return fn
