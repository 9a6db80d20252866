"""The photometric training jitter on the card: the CUDA kernel's wrapper,
its plain PyTorch version and its launch count.

The JAX package jitters a training sample's normalised camera images on
the host in NumPy (``omnihd_scenes_tpu/data/augmentation.py:55-110``
``photometric_distortion``): denormalise, brightness, contrast (mode 1),
RGB -> HSV in OpenCV's float convention, saturation, hue (mod 360),
HSV -> RGB, contrast (mode 0), a channel permutation, renormalise.  The
port draws the parameters on the host with the same ``RandomState``
calls (``data/augmentation.py:draw_photometric``, one f32 row of
``PHOTOMETRIC_FIELDS`` per view) and :func:`photometric` applies them to
a decoded batch in one launch of ``csrc/photometric.cu``: one pass over
the padded (N, H, W, 3) f32 images, pad pixels included, as the host
jitter touches them too.

Every step is an f32 operation that the kernel rounds as NumPy does
(``__fadd_rn`` / ``__fsub_rn`` / ``__fmul_rn`` / ``__fdiv_rn``: no
fused multiply-add; ``fmodf`` then NumPy's ``np.mod`` sign rule), and the
plain version takes the same steps in PyTorch (divisions by device
tensors, never by a Python scalar, which PyTorch's CUDA division turns
into a multiply by the reciprocal), so kernel, plain version and
``apply_photometric`` agree bit for bit.

No TPU kernel is replaced: the JAX package runs this on its host.  Bound:
bytes, the f32 images read and written once (~100 f32 operations a
pixel, eight of them IEEE divisions, against 24 bytes moved).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from omnihd_scenes_tpu_torch.data.augmentation import PHOTOMETRIC_FIELDS
from omnihd_scenes_tpu_torch.data.image_loading import (IMAGENET_MEAN,
                                                        IMAGENET_STD)

N_FIELDS = len(PHOTOMETRIC_FIELDS)


def _scalar(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _py_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NumPy's ``np.mod`` of f32 values by a positive ``b``: ``fmod``,
    then ``+ b`` where negative, and +0 where zero."""
    m = torch.fmod(a, b)
    m = torch.where(m < 0, m + b, m)
    return torch.where(m == 0, torch.zeros_like(m), m)


def _rgb_to_hsv(x: torch.Tensor, k):
    r, g, b = x.unbind(-1)
    v = x.amax(-1)
    mn = x.amin(-1)
    c = v - mn
    safe_c = torch.where(c > 0, c, k['1'])
    s = torch.where(v > 0, c / torch.where(v > 0, v, k['1']), k['0'])
    h = torch.where(
        c == 0, k['0'], torch.where(
            v == r, (g - b) / safe_c * k['60'], torch.where(
                v == g, (b - r) / safe_c * k['60'] + k['120'],
                (r - g) / safe_c * k['60'] + k['240'])))
    return _py_mod(h, k['360']), s, v


def _hsv_to_rgb(h, s, v, k) -> torch.Tensor:
    h60 = _py_mod(h, k['360']) / k['60']
    fl = torch.floor(h60)
    i = fl.long() % 6
    f = h60 - fl
    p = v * (k['1'] - s)
    q = v * (k['1'] - f * s)
    t = v * (k['1'] - (k['1'] - f) * s)

    def choose(*cands):
        return torch.stack(cands, -1).gather(-1, i[..., None])[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], -1)


def photometric_plain(imgs: torch.Tensor, params,
                      mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Plain version of :func:`photometric`, on any device: each image by
    its row of ``params``, the steps of ``augmentation.apply_photometric``
    in PyTorch."""
    dev = imgs.device
    rows = np.asarray(params, np.float32)
    k = {name: _scalar(v, dev) for name, v in (
        ('0', 0.0), ('1', 1.0), ('60', 60.0), ('120', 120.0),
        ('240', 240.0), ('360', 360.0))}
    mean_t, std_t = _scalar(mean, dev), _scalar(std, dev)
    out = torch.empty_like(imgs)
    for n, p in enumerate(rows):
        x = imgs[n] * std_t + mean_t
        if p[0]:
            x = x + _scalar(p[1], dev)
        if p[2] == 1 and p[3]:
            x = x * _scalar(p[4], dev)
        h, s, v = _rgb_to_hsv(x, k)
        if p[5]:
            s = s * _scalar(p[6], dev)
        if p[7]:
            h = _py_mod(h + _scalar(p[8], dev), k['360'])
        x = _hsv_to_rgb(h, s, v, k)
        if p[2] == 0 and p[3]:
            x = x * _scalar(p[4], dev)
        if p[9]:
            x = x[..., torch.as_tensor(p[10:13].astype(np.int64),
                                       device=dev)]
        out[n] = (x - mean_t) / std_t
    return out


def _check(imgs: torch.Tensor, params: np.ndarray) -> None:
    if imgs.dtype != torch.float32 or imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f'photometric: images must be (N, H, W, 3) f32, got '
                         f'{tuple(imgs.shape)} {imgs.dtype}')
    if params.shape != (imgs.shape[0], N_FIELDS):
        raise ValueError(f'photometric: params must be ({imgs.shape[0]}, '
                         f'{N_FIELDS}), got {params.shape}')
    perms = params[:, 10:13]
    if not np.all(np.sort(perms, 1) == np.arange(3, dtype=np.float32)):
        raise ValueError('photometric: each row\'s channel order must be a '
                         'permutation of (0, 1, 2)')


def photometric(imgs: torch.Tensor, params,
                mean: Sequence[float] = IMAGENET_MEAN,
                std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Normalised images (N, H, W, 3) f32 jittered by ``params`` (N,
    ``len(PHOTOMETRIC_FIELDS)``) f32 on the host, one row per image ->
    new (N, H, W, 3) f32.  CPU tensors go to :func:`photometric_plain`;
    CUDA tensors launch the kernel once or raise."""
    params = np.ascontiguousarray(np.asarray(params, np.float32))
    _check(imgs, params)
    dev = imgs.device
    if dev.type == 'cpu':
        return photometric_plain(imgs, params, mean, std)
    if dev.type != 'cuda':
        raise ValueError(f'no photometric kernel for device {dev}')
    imgs = imgs.contiguous()
    out = torch.empty_like(imgs)
    n, h, w, _ = imgs.shape
    if n * h * w == 0:
        return out
    with torch.cuda.device(dev):
        table = torch.from_numpy(params).pin_memory().to(dev,
                                                         non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(imgs.data_ptr(), table.data_ptr(), n, h * w,
                        *(float(v) for v in (*mean, *std)), out.data_ptr(),
                        stream)
    if err != 0:
        raise RuntimeError(f'photometric kernel launch failed: CUDA error '
                           f'{err}')
    photometric.launches += 1
    return out


photometric.launches = 0


def photometric_bytes(imgs: torch.Tensor) -> int:
    """Bytes the jitter must move: the f32 images read and written once
    (the rows are 52 bytes an image)."""
    return 2 * int(imgs.numel()) * imgs.element_size()


@functools.lru_cache(maxsize=None)
def _kernel():
    """``photometric_launch`` of ``csrc/photometric.cu``, with its C
    signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('photometric').photometric_launch
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_longlong,
                   *[f32] * 6, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn
