"""The crop-resize-flip training augmentation on the card: the CUDA
kernel's wrapper, its plain PyTorch version and its launch count.

The JAX package crops each normalised f32 camera image of a training
sample, resizes the crop with ``cv2.resize(..., INTER_LINEAR)`` and flips
it horizontally on a coin (``omnihd_scenes_tpu/data/augmentation.py:
193-243`` ``crop_resize_flip_images``; the homography goes into
``lidar2img`` on the host).  The port draws the parameters on the host
(``data/augmentation.py:sample_crop_resize_flip``, one
``CROP_RESIZE_FLIP_FIELDS`` row a sample, shared by its views) and
:func:`crop_resize_flip` resamples a decoded batch in one launch of
``csrc/crop_resize_flip.cu``: per output pixel, OpenCV's linear taps of
the crop (``rectify._taps_at``: the source coordinate and its fraction in
f64, the fraction rounded to f32 once, replicated borders), horizontal
then vertical ``fma(b - a, f, a)`` rounded once, the flip folded into the
store.  The plain version is ``rectify.resize_f32_plain`` of the crop,
then the flip; its ``_lerp`` rounds the fused multiply-add exactly, so
kernel and plain version agree bit for bit (both within 1e-5 of OpenCV's
f32 resize, ``tests/test_torch_port_camera_decode.py``).  A crop of the
output's size is copied, as ``cv2.resize`` copies it.

No TPU kernel is replaced: the JAX package runs this on its host.  Bound:
bytes, the crops read once and the output written once.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from omnihd_scenes_tpu_torch.data.augmentation import CROP_RESIZE_FLIP_FIELDS
from omnihd_scenes_tpu_torch.kernels.rectify import (resize_f32_plain,
                                                     resize_scales)

N_FIELDS = len(CROP_RESIZE_FLIP_FIELDS)


def _crops(shape, records: np.ndarray):
    """Per image (y0, y1, x0, x1) of NumPy's slicing ``[y0:y1, x0:x1]`` on
    an (H, W) image, and the one output size (new_h, new_w)."""
    h, w = int(shape[1]), int(shape[2])
    sizes = {(int(r[1]), int(r[0])) for r in records}
    if len(sizes) != 1:
        raise ValueError(f'crop_resize_flip: the images of a batch must '
                         f'share one output size, got {sorted(sizes)}')
    out_hw = sizes.pop()
    if min(out_hw) <= 0:
        raise ValueError(f'crop_resize_flip: output size {out_hw}')
    boxes = []
    for r in records:
        y0, y1, _ = slice(int(r[3]), int(r[5])).indices(h)
        x0, x1, _ = slice(int(r[2]), int(r[4])).indices(w)
        if y1 <= y0 or x1 <= x0:
            raise ValueError(f'crop_resize_flip: crop {r[2:6].tolist()} '
                             f'leaves nothing of a {h}x{w} image')
        boxes.append((y0, y1, x0, x1))
    return boxes, out_hw


def _records(imgs: torch.Tensor, records) -> np.ndarray:
    rec = np.ascontiguousarray(np.asarray(records, np.int64))
    if imgs.dtype != torch.float32 or imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f'crop_resize_flip: images must be (N, H, W, 3) '
                         f'f32, got {tuple(imgs.shape)} {imgs.dtype}')
    if rec.shape != (imgs.shape[0], N_FIELDS):
        raise ValueError(f'crop_resize_flip: records must be '
                         f'({imgs.shape[0]}, {N_FIELDS}), got {rec.shape}')
    return rec


def crop_resize_flip_plain(imgs: torch.Tensor, records) -> torch.Tensor:
    """Plain version of :func:`crop_resize_flip`, on any device."""
    rec = _records(imgs, records)
    boxes, (oh, ow) = _crops(imgs.shape, rec)
    out = torch.empty((imgs.shape[0], oh, ow, 3), dtype=torch.float32,
                      device=imgs.device)
    for n, ((y0, y1, x0, x1), r) in enumerate(zip(boxes, rec)):
        img = resize_f32_plain(imgs[n, y0:y1, x0:x1], (oh, ow))
        out[n] = img.flip(1) if r[6] else img
    return out


def _f64_bits(v: float) -> int:
    return struct.unpack('<q', struct.pack('<d', v))[0]


def crop_resize_flip(imgs: torch.Tensor, records) -> torch.Tensor:
    """Images (N, H, W, 3) f32, each cropped, resized and flipped by its
    row of ``records`` (N, ``len(CROP_RESIZE_FLIP_FIELDS)``) int64 on the
    host (one output size for all) -> (N, new_h, new_w, 3) f32.  CPU
    tensors go to :func:`crop_resize_flip_plain`; CUDA tensors launch the
    kernel once or raise."""
    rec = _records(imgs, records)
    dev = imgs.device
    if dev.type == 'cpu':
        return crop_resize_flip_plain(imgs, rec)
    if dev.type != 'cuda':
        raise ValueError(f'no crop_resize_flip kernel for device {dev}')
    boxes, (oh, ow) = _crops(imgs.shape, rec)
    imgs = imgs.contiguous()
    n, h, w, _ = imgs.shape
    out = torch.empty((n, oh, ow, 3), dtype=torch.float32, device=dev)
    desc = np.zeros((n, 8), np.int64)
    for i, ((y0, y1, x0, x1), r) in enumerate(zip(boxes, rec)):
        resize, sy, sx = ((y1 - y0, x1 - x0) != (oh, ow),
                          *resize_scales((y1 - y0, x1 - x0), (oh, ow))[1:])
        desc[i] = (y0, x0, y1 - y0, x1 - x0, int(bool(r[6])), int(resize),
                   _f64_bits(sy), _f64_bits(sx))
    with torch.cuda.device(dev):
        table = torch.from_numpy(desc).pin_memory().to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(imgs.data_ptr(), n, h, w, table.data_ptr(), oh, ow,
                        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'crop_resize_flip kernel launch failed: CUDA '
                           f'error {err}')
    crop_resize_flip.launches += 1
    return out


crop_resize_flip.launches = 0


def crop_resize_flip_bytes(imgs: torch.Tensor, records) -> int:
    """Bytes the augmentation must move: each image's crop read once, the
    f32 output written once."""
    rec = _records(imgs, records)
    boxes, (oh, ow) = _crops(imgs.shape, rec)
    read = sum((y1 - y0) * (x1 - x0) for y0, y1, x0, x1 in boxes)
    return (read + len(boxes) * oh * ow) * 3 * 4


@functools.lru_cache(maxsize=None)
def _kernel():
    """``crop_resize_flip_launch`` of ``csrc/crop_resize_flip.cu``, with
    its C signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('crop_resize_flip').crop_resize_flip_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn
