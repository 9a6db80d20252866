"""Argument checks and launch geometry shared by the two 3x3 convolution
kernels (``qconv``, ``bconv``), whose CUDA sources share
``csrc/conv3x3.cuh``.

Both take PyTorch's convolution layouts in channels_last memory: ``x``
(N, C, H, W) is NHWC in memory and the weight (Co, C, 3, 3) is OHWI, so
the kernel reads both with the input channels contiguous.

A tile of the kernel is 128 output pixels, a ``(BH, BW)`` rectangle of
one image, by ``BN`` output channels; :func:`tile_shape` and
:func:`block_n` choose them per call.
"""

from __future__ import annotations

import torch

CL = torch.channels_last
_K_BYTES = 128         # input-channel bytes per TMA box (128-byte swizzle)
# The block's pixel rectangles (rows, columns), in the order that breaks
# ties: squarer first.
TILE_SHAPES = ((8, 16), (16, 8), (4, 32), (2, 64))
# Codes the kernels return beside cudaError_t (csrc/conv3x3.cuh).
_ERR_NO_ENCODER, _ERR_TILE, _ERR_ENCODE = 900001, 900002, 910000


def check_shapes(name: str, x, w, scale, shift) -> None:
    """Shapes every route takes: x (N, C, H, W), w (Co, C, 3, 3), scale and
    shift (Co,) f32."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f'{name}: x must be (N, C, H, W) and w (Co, C, 3, 3), '
                         f'got {tuple(x.shape)} / {tuple(w.shape)}')
    co = w.shape[0]
    for t, label in ((scale, 'scale'), (shift, 'shift')):
        if t.shape != (co,) or t.dtype != torch.float32:
            raise ValueError(f'{name}: {label} must be ({co},) float32, got '
                             f'{tuple(t.shape)} {t.dtype}')


def check_kernel_args(name: str, x, w, scale, shift, in_dtype) -> None:
    """What the CUDA kernel takes beyond :func:`check_shapes`; raises on
    anything else (no copy, no fallback)."""
    if any(t.device != x.device for t in (w, scale, shift)):
        raise ValueError(f'{name}: inputs must share one device')
    if x.dtype != in_dtype or w.dtype != in_dtype:
        raise TypeError(f'{name} kernel takes {in_dtype} x and w, got '
                        f'{x.dtype} / {w.dtype}')
    if not (x.is_contiguous(memory_format=CL)
            and w.is_contiguous(memory_format=CL)):
        raise ValueError(f'{name}: x and w must be channels_last contiguous '
                         '(NHWC / OHWI in memory)')
    if not (scale.is_contiguous() and shift.is_contiguous()):
        raise ValueError(f'{name}: scale and shift must be contiguous')
    n, c, h, wd = x.shape
    co = w.shape[0]
    if (c * x.element_size()) % _K_BYTES or co % 8 or n * h * wd == 0:
        raise ValueError(
            f'{name} kernel needs C * itemsize % {_K_BYTES} == 0, Co % 8 == 0 '
            f'and a non-empty image, got C={c}, Co={co}, (N, H, W)='
            f'{(n, h, wd)}')
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f'{name}: x and w must be 16-byte aligned')
    if scale.data_ptr() % 8 or shift.data_ptr() % 8:
        raise ValueError(f'{name}: scale and shift must be 8-byte aligned')


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_shape(h: int, w: int) -> tuple:
    """The block's (BH, BW) pixel rectangle for an H x W image: of
    :data:`TILE_SHAPES`, the one whose tiles cover the fewest pixels
    outside the image (the first such on a tie)."""
    return min(TILE_SHAPES,
               key=lambda t: _cdiv(h, t[0]) * t[0] * _cdiv(w, t[1]) * t[1])


def block_n(co: int) -> int:
    """Output channels per block: 256 when Co is a multiple of 256 (one
    block then reads its input tile once for every 256 channels), else
    128."""
    return 256 if co % 256 == 0 else 128


def launch_args(x, w) -> tuple:
    """(N, H, W, C, Co, BH, BW, BN) for a launch."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    return (n, h, wd, c, co, *tile_shape(h, wd), block_n(co))


def raise_on_error(name: str, err: int) -> None:
    """Raise on a non-zero code from a kernel's C entry point."""
    if err == 0:
        return
    if err == _ERR_NO_ENCODER:
        why = 'the CUDA driver has no cuTensorMapEncodeTiled'
    elif err == _ERR_TILE:
        why = 'tile shape not taken by the kernel'
    elif err >= _ERR_ENCODE:
        why = f'cuTensorMapEncodeTiled returned CUresult {err - _ERR_ENCODE}'
    else:
        why = f'CUDA error {err}'
    raise RuntimeError(f'{name} kernel launch failed: {why}')


def empty_out(x, co: int, dtype: torch.dtype) -> torch.Tensor:
    n, _, h, w = x.shape
    return torch.empty((n, co, h, w), dtype=dtype, device=x.device,
                       memory_format=CL)
