"""Camera image rectification on the card: the CUDA kernel's wrapper, its
plain PyTorch version and its launch count.

The JAX package prepares each camera image on the host with OpenCV
(``omnihd_scenes_tpu/data/image_loading.py:load_camera_data``): undistort
(``cv2.remap`` on the ``CV_16SC2`` map of ``data/undistort.py``), halve
the front and back cameras (``cv2.resize`` on u8), BGR -> RGB and
``(x - mean) / std`` in f32, the global ``scale`` resize on the f32
image, then a zero pad to ``target_hw``.  This module is that chain as
one bilinear resampler over a batch of HWC images, run as up to three
passes of one kernel (``csrc/rectify.cu``), each over every image that
needs it in one launch, after a first pass that finishes the card's JPEG
decode:

0. :func:`ycbcr_to_bgr` (u8 planes -> u8 BGR): libjpeg's last two steps
   after nvJPEG's planar decode (``data/jpeg.py``), as ``cv2.imdecode``
   runs them: the "fancy" chroma upsampling of 4:2:2 / 4:2:0 streams
   (``jdsample.c`` ``h2v1`` / ``h2v2_fancy_upsample``: 3/4 of the nearer
   and 1/4 of the farther sample per axis, edges replicated, rounding
   biases 1 / 2 and 8 / 7) and the YCbCr -> BGR tables of ``jdcolor.c``
   (16-bit fixed point, clamped).

1. :func:`remap_u8` (u8 -> u8), a per-pixel source map: the map's 1/32-px
   coordinates, OpenCV's 15-bit integer bilinear weights (``(32 - fy)
   (32 - fx) 32`` ...), ``(sum + 2^14) >> 15``; ``BORDER_CONSTANT`` 0:
   a tap outside the image reads 0 and the taps inside still count.  This
   is ``cv2.remap``'s contract, which JAX's ``load_camera_data`` runs, and
   *not* that of the JAX host routine ``csrc/host_ops.cpp:121
   remap_bilinear_u8``, which zeroes a pixel when any tap is outside (that
   routine is not on JAX's camera path).
2. :func:`resize_u8` (u8 -> u8), an affine map (``cv2.resize(...,
   INTER_LINEAR)``: source ``(d + 0.5) * scale - 0.5`` with half-pixel
   centres, replicated borders).  An exact 2x downscale, which every
   shipped ``front_back_scale`` (0.5) gives, is OpenCV's area-fast path,
   the 2x2 mean with round half up, ``(a + b + c + d + 2) >> 2``; other
   factors take OpenCV's scalar fixed point (11-bit coefficients, ``(h0
   b0 + h1 b1 + 2^21) >> 22``), whose vectorised rows can round one level
   apart from it.
3. :func:`normalize_pad` (u8 -> f32): BGR -> RGB and ``(x - mean) / std``
   on each tap it reads, then the ``scale`` resize on those f32 values
   as OpenCV 5's ``cv2.resize`` computes it at every factor: the
   fraction from an f64 coordinate, horizontal then vertical, each
   ``fma(b - a, f, a)`` (bit-equal to it on the CPU at 0.5 and 0.8); the
   result goes into the zero-padded ``target_hw`` output.

The kernel's u8 passes are bit-equal to the plain versions.  Its f32 pass
rounds as the plain version does (``__fsub_rn``, ``__fdiv_rn``,
``__fmaf_rn``: nvcc contracts nothing else), whose f64 stand-in for the
FMA can round a tie the other way: within one f32 ulp.

Bound: the bytes (each u8 input read once, the output written once) over
the card's memory rate; the arithmetic is a few integer or f32 operations
a byte.  One thread per output pixel and its three channels; no shared
memory.  Nothing here replaces a TPU kernel: the JAX package runs this
chain in OpenCV on the host.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

INTER_BITS = 5
REMAP_BITS = 15
RESIZE_BITS = 11
_KIND_REMAP, _KIND_RESIZE_U8, _KIND_NORMALIZE, _KIND_YCBCR = 0, 1, 2, 3
# Chroma sampling of a planar decode (kernels/csrc/rectify.cu).
CHROMA_444, CHROMA_422, CHROMA_420 = 0, 1, 2
# jdcolor.c: FIX(1.40200), FIX(1.77200), FIX(0.71414), FIX(0.34414) at 16
# bits.
_CR_R, _CB_B, _CR_G, _CB_G = 91881, 116130, 46802, 22554
DBL_EPSILON = float(np.finfo(np.float64).eps)


# ---- the affine maps of the two resizes ----------------------------------

def resize_scales(src_hw, dst_hw) -> Tuple[bool, float, float]:
    """(area2, scale_y, scale_x) of ``cv2.resize(src, (dst_w, dst_h))``:
    the scales ``1 / (dst / src)`` in f64, and whether OpenCV takes its
    area-fast path (both scales within DBL_EPSILON of the integer 2)."""
    sy = 1.0 / (float(dst_hw[0]) / float(src_hw[0]))
    sx = 1.0 / (float(dst_hw[1]) / float(src_hw[1]))
    area2 = all(abs(s - round(s)) < DBL_EPSILON and round(s) == 2
                for s in (sy, sx))
    return area2, sy, sx


def _axis_taps(n_dst: int, n_src: int, scale: float, device):
    """OpenCV's linear taps along one axis: (s0, s1) source indices and
    the f32 weight of s1.  The source coordinate ``c = (d + 0.5) * scale -
    0.5`` and ``c - floor(c)`` are taken in f64 and the fraction rounded
    to f32 once; a tap left of 0 or at the last pixel is clamped there
    with weight 0 (replicated borders)."""
    d = torch.arange(n_dst, dtype=torch.float64, device=device)
    c = (d + 0.5) * scale - 0.5
    s = torch.floor(c)
    f = (c - s).float()
    s = s.long()
    clamp = (s < 0) | (s >= n_src - 1)
    f = torch.where(clamp, torch.zeros_like(f), f)
    s = s.clamp(0, n_src - 1)
    return s, (s + 1).clamp(max=n_src - 1), f


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``fma(b - a, f, a)`` in f32, the form OpenCV's f32 resize takes (the
    product exact in f64, the sum rounded twice: within an ulp of the
    kernel's ``__fmaf_rn``, equal to it but for a rounding tie)."""
    return ((b - a).double() * f.double() + a.double()).float()


# ---- plain versions (one image at a time) --------------------------------

def chroma_shape(hw, mode: int) -> Tuple[int, int]:
    """(h, w) of a chroma plane of an (h, w) image sampled ``mode``."""
    h, w = (int(v) for v in hw)
    return ((h + 1) // 2 if mode == CHROMA_420 else h,
            (w + 1) // 2 if mode != CHROMA_444 else w)


def upsample_chroma_plain(c: torch.Tensor, hw, mode: int) -> torch.Tensor:
    """libjpeg's fancy upsampling of one (ch, cw) u8 chroma plane to (h,
    w) int32."""
    h, w = (int(v) for v in hw)
    c = c.int()
    if mode == CHROMA_444:
        return c[:h, :w]
    ch, cw = c.shape
    x = torch.arange(w, device=c.device)
    col, odd = x // 2, (x % 2) == 1
    side = torch.where(odd, (col + 1).clamp(max=cw - 1),
                       (col - 1).clamp(min=0))
    if mode == CHROMA_422:
        near = c[:h, col] * 3
        return torch.where(odd, (near + c[:h, side] + 2) >> 2,
                           (near + c[:h, side] + 1) >> 2)
    y = torch.arange(h, device=c.device)
    r = y // 2
    far = torch.where((y % 2) == 1, (r + 1).clamp(max=ch - 1),
                      (r - 1).clamp(min=0))
    cs = c[r] * 3 + c[far]                               # (h, cw) colsums
    near = cs[:, col] * 3
    return torch.where(odd, (near + cs[:, side] + 7) >> 4,
                       (near + cs[:, side] + 8) >> 4)


def ycbcr_to_bgr_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                       mode: int) -> torch.Tensor:
    """(h, w, 3) u8 BGR from the Y plane (h, w) and the chroma planes
    (:func:`chroma_shape`) of a decoded JPEG, as libjpeg finishes a
    decode."""
    hw = y.shape
    lum = y.int()
    xb = upsample_chroma_plain(cb, hw, mode) - 128
    xr = upsample_chroma_plain(cr, hw, mode) - 128
    half = 1 << 15
    r = lum + ((_CR_R * xr + half) >> 16)
    g = lum + ((-_CB_G * xb + half - _CR_G * xr) >> 16)
    b = lum + ((_CB_B * xb + half) >> 16)
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)

def remap_u8_plain(src: torch.Tensor, fixed_map: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(src, *to_cv16sc2(fixed_map), INTER_LINEAR)`` with
    ``BORDER_CONSTANT`` 0: src (h, w, 3) u8, fixed_map (H, W, 2) int32 in
    1/32 px -> (H, W, 3) u8."""
    h, w = src.shape[:2]
    iu, iv = fixed_map[..., 0], fixed_map[..., 1]
    x0, y0 = iu >> INTER_BITS, iv >> INTER_BITS
    fx, fy = iu & 31, iv & 31
    acc = torch.zeros(fixed_map.shape[:2] + (3,), dtype=torch.int32,
                      device=src.device)
    for dy, wy in ((0, 32 - fy), (1, fy)):
        for dx, wx in ((0, 32 - fx), (1, fx)):
            ys, xs = y0 + dy, x0 + dx
            inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
            tap = src[ys.clamp(0, h - 1), xs.clamp(0, w - 1)].int()
            wgt = (wy * wx * 32 * inside).int()
            acc += tap * wgt[..., None]
    return ((acc + (1 << (REMAP_BITS - 1))) >> REMAP_BITS).clamp(
        0, 255).to(torch.uint8)


def resize_u8_plain(src: torch.Tensor, dst_hw) -> torch.Tensor:
    """``cv2.resize(src, (dst_w, dst_h))`` (INTER_LINEAR) of an (h, w, 3)
    u8 image."""
    h, w = src.shape[:2]
    dh, dw = (int(v) for v in dst_hw)
    area2, sy, sx = resize_scales((h, w), (dh, dw))
    if area2:
        s = src.int().reshape(dh, 2, dw, 2, 3).sum((1, 3))
        return ((s + 2) >> 2).to(torch.uint8)
    ys0, ys1, fy = _axis_taps(dh, h, sy, src.device)
    xs0, xs1, fx = _axis_taps(dw, w, sx, src.device)
    one = 1 << RESIZE_BITS
    ax1 = torch.round(fx * float(one)).int()
    by1 = torch.round(fy * float(one)).int()
    ax0, by0 = one - ax1, one - by1
    s = src.int()

    def hrow(rows):
        r = s[rows]
        return (r[:, xs0] * ax0[None, :, None] + r[:, xs1] * ax1[None, :, None])

    acc = hrow(ys0) * by0[:, None, None] + hrow(ys1) * by1[:, None, None]
    return ((acc + (1 << (2 * RESIZE_BITS - 1))) >> (2 * RESIZE_BITS)).clamp(
        0, 255).to(torch.uint8)


def _normalized(src: torch.Tensor, mean, std, to_rgb: bool) -> torch.Tensor:
    x = src.float()
    if to_rgb:
        x = x.flip(-1)
    dev = src.device
    return (x - torch.tensor(mean, dtype=torch.float32, device=dev)) \
        / torch.tensor(std, dtype=torch.float32, device=dev)


def resize_f32_plain(x: torch.Tensor, dst_hw) -> torch.Tensor:
    """``cv2.resize(x, (dst_w, dst_h))`` (INTER_LINEAR) of an (h, w, 3) f32
    image as OpenCV 5 computes it, at every factor (2x included):
    horizontal then vertical, each ``fma(b - a, f, a)``; the same size is
    a copy."""
    h, w = x.shape[:2]
    dh, dw = (int(v) for v in dst_hw)
    if (dh, dw) == (h, w):
        return x
    _, sy, sx = resize_scales((h, w), (dh, dw))
    ys0, ys1, fy = _axis_taps(dh, h, sy, x.device)
    xs0, xs1, fx = _axis_taps(dw, w, sx, x.device)

    def hrow(rows):
        r = x[rows]
        return _lerp(r[:, xs0], r[:, xs1], fx[None, :, None])

    return _lerp(hrow(ys0), hrow(ys1), fy[:, None, None])


def normalize_pad_plain(srcs: Sequence[torch.Tensor], dst_hws, target_hw,
                        mean, std, to_rgb: bool = True) -> torch.Tensor:
    """(N, target_h, target_w, 3) f32: each u8 image normalised, resized
    to its ``dst_hws`` entry and written at the top left of a zero
    canvas (cropped to it)."""
    th, tw = (int(v) for v in target_hw)
    out = torch.zeros((len(srcs), th, tw, 3), dtype=torch.float32,
                      device=srcs[0].device if srcs else 'cpu')
    for i, (src, hw) in enumerate(zip(srcs, dst_hws)):
        img = resize_f32_plain(_normalized(src, mean, std, to_rgb), hw)
        out[i, :img.shape[0], :img.shape[1]] = img[:th, :tw]
    return out


# ---- the wrappers ----------------------------------------------------------

def _check_images(name: str, srcs: Sequence[torch.Tensor]) -> None:
    if not srcs:
        raise ValueError(f'{name}: no image')
    dev = srcs[0].device
    for t in srcs:
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.uint8:
            raise ValueError(f'{name}: images must be (h, w, 3) uint8, got '
                             f'{tuple(t.shape)} {t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name}: images must share one device')
        if dev.type == 'cuda' and not t.is_contiguous():
            raise ValueError(f'{name}: images must be contiguous')


def _f64_bits(v: float) -> int:
    return struct.unpack('<q', struct.pack('<d', float(v)))[0]


def _descriptors(rows: List[list], device) -> torch.Tensor:
    """The launch's (n, 12) int64 descriptor table on the card, copied
    from pinned memory without a host wait."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def _launch(kind: int, desc: torch.Tensor, rows: List[list], device,
            norm=(0.0,) * 6 + (0,)) -> None:
    max_pixels = max(r[4] * r[5] for r in rows)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel()(kind, desc.data_ptr(), len(rows), max_pixels,
                        *(float(v) for v in norm[:6]), int(norm[6]), stream)
    if err != 0:
        raise RuntimeError(f'rectify kernel launch failed: CUDA error {err}')
    rectify.launches += 1


def ycbcr_to_bgr(planes: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
                 modes: Sequence[int]) -> List[torch.Tensor]:
    """BGR u8 images from decoded (Y, Cb, Cr) u8 planes (pass 0).  CPU
    tensors go to :func:`ycbcr_to_bgr_plain`; CUDA tensors launch the
    kernel once for the list (contiguous planes) or raise."""
    if not planes:
        raise ValueError('ycbcr_to_bgr: no image')
    dev = planes[0][0].device
    for (y, cb, cr), mode in zip(planes, modes):
        shape = chroma_shape(y.shape, mode)
        if (y.dim() != 2 or tuple(cb.shape) != shape
                or tuple(cr.shape) != shape
                or any(t.dtype != torch.uint8 or t.device != dev
                       for t in (y, cb, cr))):
            raise ValueError(f'ycbcr_to_bgr: planes {tuple(y.shape)} / '
                             f'{tuple(cb.shape)} / {tuple(cr.shape)} do not '
                             f'fit chroma mode {mode}')
    if dev.type == 'cpu':
        return [ycbcr_to_bgr_plain(*p, m) for p, m in zip(planes, modes)]
    if dev.type != 'cuda':
        raise ValueError(f'no ycbcr_to_bgr for device {dev}')
    if not all(t.is_contiguous() for p in planes for t in p):
        raise ValueError('ycbcr_to_bgr: planes must be contiguous')
    outs, rows = [], []
    for (y, cb, cr), mode in zip(planes, modes):
        h, w = y.shape
        o = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
        rows.append([y.data_ptr(), h, w, o.data_ptr(), h, w, h, w,
                     cb.data_ptr(), int(mode), cr.data_ptr(), 0])
        outs.append(o)
    _launch(_KIND_YCBCR, _descriptors(rows, dev), rows, dev)
    return outs


def remap_u8(srcs: Sequence[torch.Tensor],
             maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Undistort each u8 image on its fixed-point map (pass 1).  CPU
    tensors go to :func:`remap_u8_plain`; CUDA tensors launch the kernel
    once for the list (int32 contiguous (H, W, 2) maps) or raise."""
    _check_images('remap_u8', srcs)
    if len(maps) != len(srcs):
        raise ValueError('remap_u8: one map per image')
    dev = srcs[0].device
    if dev.type == 'cpu':
        return [remap_u8_plain(s, m) for s, m in zip(srcs, maps)]
    if dev.type != 'cuda':
        raise ValueError(f'no remap_u8 for device {dev}')
    for m in maps:
        if (m.device != dev or m.dtype != torch.int32 or m.dim() != 3
                or m.shape[-1] != 2 or not m.is_contiguous()):
            raise ValueError('remap_u8: maps must be contiguous (H, W, 2) '
                             'int32 on the images\' device')
    outs = [torch.empty(tuple(m.shape[:2]) + (3,), dtype=torch.uint8,
                        device=dev) for m in maps]
    rows = [[s.data_ptr(), s.shape[0], s.shape[1], o.data_ptr(),
             o.shape[0], o.shape[1], o.shape[0], o.shape[1], m.data_ptr(),
             0, 0, 0] for s, o, m in zip(srcs, outs, maps)]
    _launch(_KIND_REMAP, _descriptors(rows, dev), rows, dev)
    return outs


def resize_u8(srcs: Sequence[torch.Tensor], dst_hws) -> List[torch.Tensor]:
    """``cv2.resize`` (INTER_LINEAR) of each u8 image to its size (pass
    2).  CPU tensors go to :func:`resize_u8_plain`; CUDA tensors launch
    the kernel once for the list or raise."""
    _check_images('resize_u8', srcs)
    dev = srcs[0].device
    if dev.type == 'cpu':
        return [resize_u8_plain(s, hw) for s, hw in zip(srcs, dst_hws)]
    if dev.type != 'cuda':
        raise ValueError(f'no resize_u8 for device {dev}')
    outs, rows = [], []
    for s, (dh, dw) in zip(srcs, dst_hws):
        o = torch.empty((int(dh), int(dw), 3), dtype=torch.uint8, device=dev)
        area2, sy, sx = resize_scales(s.shape[:2], (dh, dw))
        rows.append([s.data_ptr(), s.shape[0], s.shape[1], o.data_ptr(),
                     int(dh), int(dw), int(dh), int(dw), 0, int(area2),
                     _f64_bits(sy), _f64_bits(sx)])
        outs.append(o)
    _launch(_KIND_RESIZE_U8, _descriptors(rows, dev), rows, dev)
    return outs


def normalize_pad(srcs: Sequence[torch.Tensor], dst_hws, target_hw,
                  mean, std, to_rgb: bool = True) -> torch.Tensor:
    """Normalise, resize and zero-pad each u8 image into one (N,
    target_h, target_w, 3) f32 tensor (pass 3).  CPU tensors go to
    :func:`normalize_pad_plain`; CUDA tensors launch the kernel once or
    raise."""
    _check_images('normalize_pad', srcs)
    dev = srcs[0].device
    if dev.type == 'cpu':
        return normalize_pad_plain(srcs, dst_hws, target_hw, mean, std,
                                   to_rgb)
    if dev.type != 'cuda':
        raise ValueError(f'no normalize_pad for device {dev}')
    th, tw = (int(v) for v in target_hw)
    out = torch.empty((len(srcs), th, tw, 3), dtype=torch.float32,
                      device=dev)
    rows = []
    for i, (s, (dh, dw)) in enumerate(zip(srcs, dst_hws)):
        _, sy, sx = resize_scales(s.shape[:2], (dh, dw))
        same = (int(dh), int(dw)) == tuple(s.shape[:2])
        rows.append([s.data_ptr(), s.shape[0], s.shape[1], out[i].data_ptr(),
                     th, tw, int(dh), int(dw), 0, int(same),
                     _f64_bits(sy), _f64_bits(sx)])
    _launch(_KIND_NORMALIZE, _descriptors(rows, dev), rows, dev,
            (*mean, *std, int(bool(to_rgb))))
    return out


def rectify(images: Sequence[torch.Tensor],
            maps: Sequence[Optional[torch.Tensor]], u8_hws, out_hws,
            target_hw, mean, std, to_rgb: bool = True) -> torch.Tensor:
    """The whole chain for a batch of decoded BGR u8 images: undistort
    those with a map, downscale those whose ``u8_hws`` entry differs from
    their size, then normalise, resize to ``out_hws`` and pad to
    ``target_hw`` -> (N, target_h, target_w, 3) f32.  On CUDA tensors:
    at most three launches (one per pass that any image needs)."""
    images = list(images)
    todo = [i for i, m in enumerate(maps) if m is not None]
    if todo:
        for i, img in zip(todo, remap_u8([images[i] for i in todo],
                                         [maps[i] for i in todo])):
            images[i] = img
    todo = [i for i, hw in enumerate(u8_hws)
            if tuple(hw) != tuple(images[i].shape[:2])]
    if todo:
        for i, img in zip(todo, resize_u8([images[i] for i in todo],
                                          [u8_hws[i] for i in todo])):
            images[i] = img
    return normalize_pad(images, out_hws, target_hw, mean, std, to_rgb)


rectify.launches = 0


def rectify_plain(images, maps, u8_hws, out_hws, target_hw, mean, std,
                  to_rgb: bool = True) -> torch.Tensor:
    """Plain version of :func:`rectify`, on any device."""
    staged = []
    for img, m, hw in zip(images, maps, u8_hws):
        if m is not None:
            img = remap_u8_plain(img, m)
        if tuple(hw) != tuple(img.shape[:2]):
            img = resize_u8_plain(img, hw)
        staged.append(img)
    return normalize_pad_plain(staged, out_hws, target_hw, mean, std, to_rgb)


def rectify_bytes(images, maps, target_hw) -> int:
    """Bytes the chain must move: each decoded u8 image and each distinct
    map read once (cameras of one calibration share theirs), the f32
    output written once (the u8 intermediates stay out of the count: a
    fused chain need not store them)."""
    n = sum(int(t.numel()) for t in images)
    n += sum(int(m.numel()) * 4 for m in
             {m.data_ptr(): m for m in maps if m is not None}.values())
    return n + len(images) * int(target_hw[0]) * int(target_hw[1]) * 3 * 4


@functools.lru_cache(maxsize=None)
def _kernel():
    """``rectify_launch`` of ``csrc/rectify.cu``, with its C signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('rectify').rectify_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong] + [ctypes.c_float] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
