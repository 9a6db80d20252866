"""Camera image rectification on the card: the CUDA kernel's wrapper, its
plain PyTorch version and its launch count.

The JAX package prepares each camera image on the host with OpenCV
(``omnihd_scenes_tpu/data/image_loading.py:load_camera_data``): decode
(``cv2.imread``), undistort (``cv2.remap`` on the ``CV_16SC2`` map of
``data/undistort.py``), halve the front and back cameras (``cv2.resize``
on u8), BGR -> RGB and ``(x - mean) / std`` in f32, the global ``scale``
resize on the f32 image, then a zero pad to ``target_hw``.  On the card
the decode stops at the Y / Cb / Cr planes (``data/jpeg.py``, libjpeg's
entropy decode and IDCT), and :func:`rectify` runs the rest, from the
planes to the padded f32 images of a whole batch, in one launch of
``csrc/rectify.cu`` that writes no intermediate image.  The plain version
runs the steps one after the other:

0. :func:`ycbcr_to_bgr_plain` (u8 planes -> u8 BGR): libjpeg's last two
   steps, as ``cv2.imdecode`` runs them: the "fancy" chroma upsampling of
   4:2:2 / 4:2:0 streams (``jdsample.c`` ``h2v1`` / ``h2v2_fancy_upsample``:
   3/4 of the nearer and 1/4 of the farther sample per axis, edges
   replicated, rounding biases 1 / 2 and 8 / 7), or the box replication
   ``h2v1_upsample`` that a reduced decode leaves at 1/8
   (:data:`CHROMA_422_BOX`), and the YCbCr -> BGR tables of
   ``jdcolor.c`` (16-bit fixed point, clamped).
1. :func:`remap_u8_plain` (u8 -> u8), a per-pixel source map (the
   undistorted image U has the map's size, which is the decoded one's
   but for the fused map of a reduced decode, ``data/undistort.py:
   fused_rectify_map``, whose size is the output's): the map's
   1/32-px coordinates, OpenCV's 15-bit integer bilinear weights, ``(32 -
   fy) (32 - fx) 32`` ..., ``(sum + 2^14) >> 15``; ``BORDER_CONSTANT`` 0:
   a tap outside the image reads 0 and the taps inside still count.  This
   is ``cv2.remap``'s contract, which JAX's ``load_camera_data`` runs, and
   *not* that of the JAX host routine ``csrc/host_ops.cpp:121
   remap_bilinear_u8``, which zeroes a pixel when any tap is outside (that
   routine is not on JAX's camera path).
2. :func:`resize_u8_plain` (u8 -> u8), an affine map (``cv2.resize(...,
   INTER_LINEAR)``: source ``(d + 0.5) * scale - 0.5`` with half-pixel
   centres, replicated borders).  An exact 2x downscale, which every
   shipped ``front_back_scale`` (0.5) gives, is OpenCV's area-fast path,
   the 2x2 mean with round half up, ``(a + b + c + d + 2) >> 2``; other
   factors take OpenCV's scalar fixed point (11-bit coefficients, ``(h0
   b0 + h1 b1 + 2^21) >> 22``), whose vectorised rows can round one level
   apart from it.
3. :func:`normalize_pad_plain` (u8 -> f32): BGR -> RGB and ``(x - mean) /
   std`` on each tap it reads, then the ``scale`` resize on those f32
   values as OpenCV 5's ``cv2.resize`` computes it at every factor: the
   fraction from an f64 coordinate, horizontal then vertical, each
   ``fma(b - a, f, a)`` (rounded once: :func:`_lerp` emulates the fused
   multiply-add exactly); the result goes into the zero-padded
   ``target_hw`` output.

The JAX fast decode (``image_fast_decode``) is this chain with a
reduced decode's planes, the fused map (or, without distortion, the u8
resize to the output size) and no f32 resize: ``u8_hws`` and
``out_hws`` are then both the output size.

Every intermediate before the f32 resize is an integer, and the kernel
rounds its f32 steps as the plain version does (``__fsub_rn``,
``__fdiv_rn``, ``__fmaf_rn``), so :func:`rectify` on the card is
bit-equal to :func:`rectify_plain`.

Bound: the bytes (each plane and each distinct map read once, the output
written once) over the card's memory rate.  The kernel stages, per tile
of output, the decoded pixels and map entries the tile reads in shared
memory and computes each output pixel from them (``csrc/rectify.cu``).
What it reads besides the planes comes from two setup kernels of the
same file, each with its wrapper, plain version and launch count: the
map's packed form (:func:`pack_map`, once per map, when a
:class:`DeviceMap` is made), and in one launch per map and image
geometry (:func:`geometry_tables`) each content tile's source rectangle
and its footprint on the map and the f32 resize's taps, kept in the
:class:`DeviceMap` (or by geometry for images without a map).
``data/image_loading.py:_device_map`` keeps one :class:`DeviceMap` per
calibration, so on the camera feed they run at a map's first use.
Nothing here replaces a TPU kernel: the JAX package runs this chain in
OpenCV on the host.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

INTER_BITS = 5
REMAP_BITS = 15
RESIZE_BITS = 11
# Chroma sampling of a planar decode (kernels/csrc/rectify.cu); 4:2:2
# chroma upsampled by box replication (a reduced decode at 1/8).
CHROMA_444, CHROMA_422, CHROMA_420, CHROMA_422_BOX = 0, 1, 2, 3
# How the u8 image reaches its size (csrc/rectify.cu U8Kind).
_U8_SAME, _U8_AREA2, _U8_BILINEAR = 0, 1, 2
# csrc/rectify.cu: a CTA's tile is 32 output columns by 8, 16 or 32 rows;
# it stages the map entries of the undistorted pixels the tile reads and
# the decoded pixels their taps read when they fit these counts.
_TILE_W, _MAP_ENTRIES, _STAGE_PIXELS = 32, 4352, 4800
# csrc/rectify.cu kFarFootprint: a tile whose map entries the packed map
# cannot hold.
_FAR_FOOTPRINT = -(1 << 30)
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


def _taps_at(d: torch.Tensor, n_src: int, scale: float):
    """OpenCV's linear taps of the destination indices ``d`` along one
    axis: (s0, s1) source indices and the f32 weight of s1.  The source
    coordinate ``c = (d + 0.5) * scale - 0.5`` and ``c - floor(c)`` are
    taken in f64 and the fraction rounded to f32 once; a tap left of 0 or
    at the last pixel is clamped there with weight 0 (replicated
    borders)."""
    c = (d.double() + 0.5) * scale - 0.5
    s = torch.floor(c)
    f = (c - s).float()
    s = s.long()
    clamp = (s < 0) | (s >= n_src - 1)
    f = torch.where(clamp, torch.zeros_like(f), f)
    s = s.clamp(0, n_src - 1)
    return s, (s + 1).clamp(max=n_src - 1), f


def _axis_taps(n_dst: int, n_src: int, scale: float, device):
    """:func:`_taps_at` of every destination index ``0 .. n_dst - 1``."""
    return _taps_at(torch.arange(n_dst, device=device), n_src, scale)


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``fma(b - a, f, a)`` in f32 with one rounding, the form OpenCV's f32
    resize takes and the kernel's ``__fmaf_rn``: the product is exact in
    f64, the f64 sum is rounded to odd (its error, from the two-sum,
    decides the last bit), and rounding that to f32 is the correctly
    rounded fused result (53 >= 24 + 2 bits)."""
    a64 = a.double()
    p = (b - a).double() * f.double()
    s = p + a64
    bp = s - p
    err = (p - (s - bp)) + (a64 - bp)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


# ---- plain versions (one image at a time) --------------------------------

class Planes(NamedTuple):
    """A decoded JPEG's planes: Y (h, w) and Cb, Cr (:func:`chroma_shape`)
    u8, unit stride along a row, and the chroma mode (``CHROMA_*``)."""
    y: torch.Tensor
    cb: torch.Tensor
    cr: torch.Tensor
    mode: int


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
    if mode == CHROMA_422_BOX:
        return c[:h, col]
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
    1/32 px (any H, W) -> (H, W, 3) u8."""
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


def rectify_plain(planes: Sequence[Planes], maps, u8_hws, out_hws,
                  target_hw, mean, std, to_rgb: bool = True) -> torch.Tensor:
    """Plain version of :func:`rectify`, on any device: the steps one
    after the other."""
    staged = []
    for p, m, hw in zip(planes, maps, u8_hws):
        img = ycbcr_to_bgr_plain(*p)
        if m is not None:
            img = remap_u8_plain(img, _fixed(m))
        if tuple(hw) != tuple(img.shape[:2]):
            img = resize_u8_plain(img, hw)
        staged.append(img)
    return normalize_pad_plain(staged, out_hws, target_hw, mean, std, to_rgb)


# ---- the wrapper -----------------------------------------------------------

def _check_planes(planes: Sequence[Planes], maps) -> torch.device:
    if not planes:
        raise ValueError('rectify: no image')
    if len(maps) != len(planes):
        raise ValueError('rectify: one map (or None) per image')
    dev = planes[0].y.device
    cuda = dev.type == 'cuda'
    u8 = torch.uint8
    for (y, cb, cr, mode), m in zip(planes, maps):
        m = _fixed(m)
        hw = y.shape
        shape = chroma_shape(hw, mode) if len(hw) == 2 and mode in (
            CHROMA_444, CHROMA_422, CHROMA_420, CHROMA_422_BOX) else None
        if (shape is None or cb.shape != shape or cr.shape != shape
                or y.dtype is not u8 or cb.dtype is not u8
                or cr.dtype is not u8 or y.device != dev
                or cb.device != dev or cr.device != dev):
            raise ValueError(f'rectify: planes {tuple(hw)} / '
                             f'{tuple(cb.shape)} / {tuple(cr.shape)} do '
                             f'not fit chroma mode {mode}')
        if m is not None and (m.dtype is not torch.int32 or m.dim() != 3
                              or m.shape[2] != 2 or m.device != dev):
            raise ValueError('rectify: maps must be (H, W, 2) int32 on the '
                             'planes\' device')
        if cuda and (y.stride(1) != 1 or cb.stride(1) != 1
                     or cb.stride() != cr.stride()
                     or (m is not None and not m.is_contiguous())):
            raise ValueError('rectify: planes need unit column strides and '
                             'one pitch for Cb and Cr; maps must be '
                             'contiguous')
    return dev


def _f64_bits(v: float) -> int:
    return struct.unpack('<q', struct.pack('<d', float(v)))[0]


def _tile_rows(hw, out_hw) -> int:
    """Rows of 8 output rows a tile of the image spans: the most (of 4, 2,
    1) whose decoded footprint, at the image's scale and with a margin
    for the taps and the distortion, fits the kernel's stage."""
    ry = hw[0] / max(out_hw[0], 1)
    rx = hw[1] / max(out_hw[1], 1)
    for r in (4, 2, 1):
        if ((8 * r * ry + 1) * (_TILE_W * rx + 1) <= _MAP_ENTRIES
                and (8 * r * ry + 3) * (_TILE_W * rx + 3)
                <= 0.97 * _STAGE_PIXELS):
            return r
    return 1


def _tiles(r: int, out_hw, target_hw) -> Tuple[int, int]:
    """(content tiles, all tiles) of an image in the kernel's grid: 32 x
    8r tiles over its resized image (cut to the canvas), then 32 x 32
    tiles that zero the canvas below and to the right of them."""
    th, tw = target_hw
    tx = -(-min(out_hw[1], tw) // _TILE_W)
    ty = -(-min(out_hw[0], th) // (8 * r))
    rc, cc = min(ty * 8 * r, th), min(tx * _TILE_W, tw)
    below = -(-(th - rc) // 32) * -(-tw // 32)
    right = -(-rc // 32) * -(-(tw - cc) // 32)
    return tx * ty, tx * ty + below + right


@functools.lru_cache(maxsize=256)
def _geometry(h, w, mode, u8_hw, out_hw, target_hw, u_hw=None):
    """The descriptor words of an image's sizes, sampling and scales (words
    5-9 and 11-20, then the undistorted image's size ``u_hw``, the map's,
    default (h, w), for word 29), its tile height and its (content, all)
    tile counts."""
    u8h, u8w = u8_hw
    oh, ow = out_hw
    uh, uw = u_hw if u_hw is not None else (h, w)
    area2, usy, usx = resize_scales((uh, uw), (u8h, u8w))
    kind = (_U8_SAME if (u8h, u8w) == (uh, uw)
            else _U8_AREA2 if area2 else _U8_BILINEAR)
    _, fsy, fsx = resize_scales((u8h, u8w), (oh, ow))
    r = _tile_rows((h, w), (oh, ow))
    return ((h, w, *chroma_shape((h, w), mode), int(mode), uh, uw),
            (u8h, u8w, kind, _f64_bits(usy), _f64_bits(usx), oh, ow,
             int((oh, ow) != (u8h, u8w)), _f64_bits(fsy), _f64_bits(fsx)),
            r, *_tiles(r, out_hw, target_hw))


def _align(ptrs, pitch: int, width: int) -> int:
    """The widest copy (16, 8 or 1 bytes) that rows of planes at ``ptrs``
    allow: rows start aligned and their pitch holds the width rounded up
    (views of whole rows of a row-major buffer, as the decode's planes
    are)."""
    for a in (16, 8):
        if (all(p % a == 0 for p in ptrs) and pitch % a == 0
                and -(-width // a) * a <= pitch):
            return a
    return 1


def _f64(bits: int) -> float:
    return struct.unpack('<d', struct.pack('<q', int(bits)))[0]


def _geometry_row(geometry, map_ptr: int = 0) -> list:
    """A descriptor row (``csrc/rectify.cu`` ``Img``) of an image geometry
    (:func:`_geometry`) without planes: the words
    ``geometry_tables_kernel`` reads (sizes, the map, scales, tile height,
    content tiles)."""
    sizes, scales, r, content, _ = geometry
    row = [0] * 30
    row[5:10], row[10], row[11:21] = sizes[:5], map_ptr, scales
    row[22], row[28], row[29] = r, content, _u_word(sizes)
    return row


def _u_word(sizes) -> int:
    """Descriptor word 29: the undistorted image's (h, w) as h | w <<
    32."""
    return int(sizes[5]) | int(sizes[6]) << 32


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f'{what} launch failed: CUDA error {err}')


# ---- the setup kernels: packed map, tile footprints, resize taps ---------

def pack_map_plain(fixed: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pack_map`, on any device."""
    h, w = fixed.shape[:2]
    e = fixed.long()
    dx = (e[..., 0] >> INTER_BITS) - torch.arange(w, device=fixed.device)
    dy = (e[..., 1] >> INTER_BITS) - torch.arange(
        h, device=fixed.device)[:, None]
    v = ((dx & 2047) | (dy & 2047) << 11 | (e[..., 0] & 31) << 22
         | (e[..., 1] & 31) << 27)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).int()


def pack_map(fixed: torch.Tensor) -> torch.Tensor:
    """The packed form (h, w) int32 of an undistortion map (h, w, 2) int32
    in 1/32 px, as the rectify kernel stages it: each entry's whole-pixel
    displacement from its own pixel (x, then y, 11 bits each, two's
    complement: 1024 px or more wraps, and :func:`geometry_tables` marks
    such tiles) and its fractions (x, then y, 5 bits each).  CPU tensors
    go to :func:`pack_map_plain`; CUDA tensors launch ``pack_map_kernel``
    once or raise."""
    if fixed.device.type == 'cpu':
        return pack_map_plain(fixed)
    if fixed.device.type != 'cuda' or fixed.dtype is not torch.int32 \
            or fixed.dim() != 3 or fixed.shape[2] != 2:
        raise ValueError('pack_map: an (h, w, 2) int32 map on the card')
    fixed = fixed.contiguous()
    h, w = fixed.shape[:2]
    out = torch.empty((h, w), dtype=torch.int32, device=fixed.device)
    with torch.cuda.device(fixed.device):
        err = _entry('rectify_pack_map_launch')(
            fixed.data_ptr(), h, w, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'pack_map')
    pack_map.launches += 1
    return out


def footprint_table_plain(fixed: Optional[torch.Tensor], geometry,
                          target_hw, device='cpu') -> torch.Tensor:
    """The footprint part of :func:`geometry_tables_plain`, on any device
    (the map's, else ``device``)."""
    sizes, (u8h, u8w, kind, usy, usx, oh, ow, resize, fsy, fsx), r, \
        content, _ = geometry
    h, w = sizes[5:7]                                    # U's size
    th, tw = (int(v) for v in target_hw)
    dev = fixed.device if fixed is not None else torch.device(device)
    tiles_x = -(-min(ow, tw) // _TILE_W)
    t = torch.arange(content, device=dev)
    y0, x0 = (t // tiles_x) * 8 * r, (t % tiles_x) * _TILE_W
    y1 = (y0 + 8 * r).clamp(max=min(th, oh)) - 1
    x1 = (x0 + _TILE_W).clamp(max=min(tw, ow)) - 1

    def span(lo, hi, fs, n_u8, us, n):
        # The rows (columns) of S, then of U, that output rows lo..hi read.
        if resize:
            lo, hi = _taps_at(lo, n_u8, _f64(fs))[0], \
                _taps_at(hi, n_u8, _f64(fs))[1]
        if kind == _U8_AREA2:
            return 2 * lo, 2 * hi + 1
        if kind == _U8_BILINEAR:
            return _taps_at(lo, n, _f64(us))[0], _taps_at(hi, n, _f64(us))[1]
        return lo, hi

    uy0, uy1 = span(y0, y1, fsy, u8h, usy, h)
    ux0, ux1 = span(x0, x1, fsx, u8w, usx, w)
    rect = torch.stack([uy0, uy1, ux0, ux1], 1)
    if fixed is None:
        foot = torch.stack([uy0, uy1 - 1, ux0, ux1 - 1], 1)
    else:
        ex, ey = fixed[..., 0].long() >> INTER_BITS, \
            fixed[..., 1].long() >> INTER_BITS
        dy = ey - torch.arange(h, device=dev)[:, None]
        dx = ex - torch.arange(w, device=dev)
        far = (dy < -1024) | (dy > 1023) | (dx < -1024) | (dx > 1023)
        rows = []
        for a, b, c, d in rect.tolist():
            cut = (slice(a, b + 1), slice(c, d + 1))
            rows.append(torch.stack([
                ey[cut].min(), ey[cut].max(),
                torch.where(far[cut].any(), _FAR_FOOTPRINT, ex[cut].min()),
                ex[cut].max()]))
        foot = torch.stack(rows)
    return torch.stack([rect, foot], 1).reshape(-1, 4).int()


def resize_taps_plain(geometry, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The taps part of :func:`geometry_tables_plain`, on any device."""
    _, (u8h, u8w, _, _, _, oh, ow, _, fsy, fsx), *_ = geometry

    def table(n, n_src, scale):
        d = torch.arange(n + 31, device=device).clamp(max=n - 1)
        s0, s1, f = _taps_at(d, n_src, _f64(scale))
        return torch.stack([s0.int(), s1.int(), f.view(torch.int32),
                            torch.zeros_like(f, dtype=torch.int32)], 1)

    return table(oh, u8h, fsy), table(ow, u8w, fsx)


def geometry_tables_plain(fixed: Optional[torch.Tensor], geometry,
                          target_hw, device=None) -> tuple:
    """Plain version of :func:`geometry_tables`, on any device (the map's,
    else ``device``)."""
    dev = fixed.device if fixed is not None else torch.device(device)
    return (footprint_table_plain(fixed, geometry, target_hw, dev),
            *resize_taps_plain(geometry, dev))


def geometry_tables(fixed: Optional[torch.Tensor], geometry, target_hw,
                    device=None) -> tuple:
    """The tables the rectify kernel reads for an image geometry
    (:func:`_geometry`) on a ``target_hw`` canvas, with the map ``fixed``
    or None: (footprint, row taps, column taps).

    The footprint, (2 content tiles, 4) int32: for each content tile the
    rectangle of the undistorted image (U) its output pixels read (first
    row, last row, first column, last column), then its footprint on the
    map: the least and largest whole-pixel map row and column over that
    rectangle (the rectangle itself, its last row and column less one,
    without a map), with the least column ``_FAR_FOOTPRINT`` where an
    entry lies 1024 px or more from its pixel (the packed map cannot hold
    it; that tile reads the planes directly).  The f32 resize's taps,
    (oh + 31, 4) for the output rows, then (ow + 31, 4) for the columns,
    int32 (s0, s1, the f32 weight's bits, 0) as :func:`_taps_at` gives
    them, the last one repeated 31 times so that a tile reads 32 without a
    bound.  On the map's device, else ``device``: the CPU goes to
    :func:`geometry_tables_plain`, the card launches
    ``geometry_tables_kernel`` once for all three or raises."""
    dev = fixed.device if fixed is not None else torch.device(device)
    if dev.type == 'cpu':
        return geometry_tables_plain(fixed, geometry, target_hw, dev)
    if dev.type != 'cuda':
        raise ValueError(f'no geometry_tables for device {dev}')
    th, tw = (int(v) for v in target_hw)
    content = geometry[3]
    oh, ow = geometry[1][5:7]
    table = torch.empty((2 * content, 4), dtype=torch.int32, device=dev)
    rows, cols = (torch.empty((n + 31, 4), dtype=torch.int32, device=dev)
                  for n in (oh, ow))
    row = np.array(_geometry_row(
        geometry, 0 if fixed is None else fixed.data_ptr()), np.int64)
    with torch.cuda.device(dev):
        err = _entry('rectify_tables_launch')(
            row.ctypes.data, th, tw, content, oh, ow, table.data_ptr(),
            rows.data_ptr(), cols.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'geometry_tables')
    geometry_tables.launches += 1
    return table, rows, cols


pack_map.launches = geometry_tables.launches = 0


class DeviceMap:
    """An undistortion map as the rectify kernel reads it: ``fixed`` (h, w,
    2) int32 in 1/32 px on the card, its :func:`pack_map` (made here) and,
    by image geometry and canvas, the :func:`geometry_tables` that
    :func:`rectify` makes at its first use of them.  Keep one per
    calibration (``data/image_loading.py:_device_map`` does) so that they
    are made once."""

    def __init__(self, fixed: torch.Tensor):
        self.fixed = fixed.contiguous()
        self.packed = pack_map(self.fixed)
        self.tables: dict = {}


MapLike = Union[None, torch.Tensor, DeviceMap]


def _fixed(m: MapLike) -> Optional[torch.Tensor]:
    return m.fixed if isinstance(m, DeviceMap) else m


def _device_maps(maps: Sequence[MapLike]) -> list:
    """``maps`` with each raw map tensor made a :class:`DeviceMap` (one per
    tensor, for this call)."""
    made = {}
    out = []
    for m in maps:
        if m is not None and not isinstance(m, DeviceMap):
            if id(m) not in made:
                made[id(m)] = DeviceMap(m)
            m = made[id(m)]
        out.append(m)
    return out


def _tables(m: Optional[DeviceMap], geometry, target_hw, device) -> tuple:
    """The pointers of what the kernel reads besides an image's planes:
    its packed map (0 without a map), footprint table, row and column
    taps; the tables made at their first use and kept in the map (by
    geometry in ``_TABLES`` without one)."""
    if m is None:
        store, key = _TABLES, (geometry, target_hw, str(device))
    else:
        store, key = m.tables, (geometry, target_hw)
    found = store.get(key)
    if found is None:
        found = geometry_tables(_fixed(m), geometry, target_hw, device)
        store[key] = found
    packed = 0 if m is None else m.packed.data_ptr()
    return (packed, *(t.data_ptr() for t in found))


def _descriptor_rows(planes, maps, u8_hws, out_hws, out, target_hw,
                     interleave: bool = True):
    """The kernel's descriptor table (``csrc/rectify.cu`` ``Img``): one row
    of int64 words per image (``maps``: :class:`DeviceMap` or None); the
    groups (first launch tile, first image, size, 0), with ``interleave``
    the images of one geometry and map in one group, whose tiles take
    turns image by image, else one group an image; and the launch's tile
    count."""
    target = tuple(int(v) for v in target_hw)
    dst, dst_step = out.data_ptr(), out.stride(0) * out.element_size()
    groups = {}
    for i, ((y, cb, cr, mode), m, u8, hw) in enumerate(
            zip(planes, maps, u8_hws, out_hws)):
        h, w = y.shape
        geometry = _geometry(h, w, int(mode), tuple(int(v) for v in u8),
                             tuple(int(v) for v in hw), target,
                             None if m is None else tuple(m.fixed.shape[:2]))
        sizes, scales, r, content, tiles = geometry
        yp, cp, rp = y.data_ptr(), cb.data_ptr(), cr.data_ptr()
        ypitch, cpitch = y.stride(0), cb.stride(0)
        flags = (_align((yp,), ypitch, w)
                 | _align((cp, rp), cpitch, sizes[3]) << 8)
        mp = 0 if m is None else m.fixed.data_ptr()
        row = [yp, ypitch, cp, rp, cpitch, *sizes[:5], mp, *scales,
               dst + i * dst_step, r, flags,
               *_tables(m, geometry, target, out.device), content,
               _u_word(sizes)]
        key = (sizes, scales, mp) if interleave else i
        groups.setdefault(key, []).append((row, tiles))
    rows, heads, first = [], [], 0
    for members in groups.values():
        tiles = members[0][1]
        heads.append([first, len(rows), len(members), 0])
        rows += [row for row, _ in members]
        first += tiles * len(members)
    return rows, heads, first


def _norm_lut(mean, std, device) -> torch.Tensor:
    """(3, 256) f32 on ``device``: (v - mean[c]) / std[c], each step in f32
    as :func:`_normalized` rounds it; made once per mean, std and
    device."""
    key = (tuple(float(np.float32(v)) for v in (*mean, *std)), str(device))
    lut = _LUTS.get(key)
    if lut is None:
        v = torch.arange(256, dtype=torch.float32)
        lut = torch.stack([
            (v - torch.tensor(mu, dtype=torch.float32))
            / torch.tensor(sd, dtype=torch.float32)
            for mu, sd in zip(mean, std)])
        lut = lut.pin_memory().to(device, non_blocking=True)
        _LUTS[key] = lut
    return lut


def rectify(planes: Sequence[Planes], maps: Sequence[MapLike], u8_hws,
            out_hws, target_hw, mean, std, to_rgb: bool = True) -> torch.Tensor:
    """The whole chain for a batch of decoded JPEG planes: YCbCr -> BGR,
    undistort those with a map (a :class:`DeviceMap`, or the raw (h, w, 2)
    int32 map, whose tables are then made for this call), downscale those
    whose ``u8_hws`` entry differs from their size, then normalise, resize
    to ``out_hws`` and pad to ``target_hw`` -> (N, target_h, target_w, 3)
    f32.  CPU tensors go to :func:`rectify_plain`; CUDA tensors launch the
    kernel once (after the setup kernels of tables not yet made) or
    raise."""
    dev = _check_planes(planes, maps)
    if dev.type == 'cpu':
        return rectify_plain(planes, maps, u8_hws, out_hws, target_hw, mean,
                             std, to_rgb)
    if dev.type != 'cuda':
        raise ValueError(f'no rectify for device {dev}')
    return _launch(planes, _device_maps(maps), u8_hws, out_hws, target_hw,
                   mean, std, to_rgb)


def _launch(planes, maps, u8_hws, out_hws, target_hw, mean, std,
            to_rgb: bool = True, interleave: bool = True) -> torch.Tensor:
    """One launch of the rectify kernel on checked CUDA planes and
    :class:`DeviceMap` maps (``interleave``: :func:`_descriptor_rows`)."""
    dev = planes[0].y.device
    th, tw = (int(v) for v in target_hw)
    out = torch.empty((len(planes), th, tw, 3), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rows, heads, tiles = _descriptor_rows(planes, maps, u8_hws, out_hws,
                                              out, (th, tw), interleave)
        desc = torch.from_numpy(np.concatenate([
            np.array(rows, dtype=np.int64).reshape(-1),
            np.array(heads, dtype=np.int64).reshape(-1)])).pin_memory().to(
                dev, non_blocking=True)
        lut = _norm_lut(mean, std, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry('rectify_launch')(
            desc.data_ptr(), len(rows), len(heads), tiles, th, tw,
            lut.data_ptr(), int(bool(to_rgb)), stream)
    _raise_on(err, 'rectify kernel')
    rectify.launches += 1
    return out


rectify.launches = 0
# The tables of images without a map, by geometry, canvas and device; the
# normalisation tables.
_TABLES: dict = {}
_LUTS: dict = {}


def planes_to_bgr(planes: Sequence[Planes]):
    """(h, w, 3) u8 BGR images of decoded planes, as ``cv2.imdecode``
    returns them: :func:`ycbcr_to_bgr_plain` on the CPU; on the card one
    :func:`rectify` launch with nothing but the colour step (no map, no
    resize, mean 0, std 1, BGR kept), whose f32 values are the u8 ones."""
    if planes[0].y.device.type == 'cpu':
        return [ycbcr_to_bgr_plain(*p) for p in planes]
    hws = [tuple(p.y.shape) for p in planes]
    canvas = (max(h for h, _ in hws), max(w for _, w in hws))
    f32 = rectify(planes, [None] * len(planes), hws, hws, canvas,
                  (0.0,) * 3, (1.0,) * 3, to_rgb=False)
    return [f32[i, :h, :w].to(torch.uint8) for i, (h, w) in enumerate(hws)]


def rectify_bytes(planes: Sequence[Planes], maps, target_hw) -> int:
    """Bytes the chain must move: each image's planes and each distinct
    map read once (cameras of one calibration share theirs), the f32
    output written once."""
    n = sum(int(t.numel()) for p in planes for t in p[:3])
    fixed = [_fixed(m) for m in maps if m is not None]
    n += sum(int(m.numel()) * 4 for m in
             {m.data_ptr(): m for m in fixed}.values())
    return n + len(planes) * int(target_hw[0]) * int(target_hw[1]) * 3 * 4


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of csrc/rectify.cu and their argument types.
_SIGNATURES = {
    'rectify_launch': [_P] + [_I] * 5 + [_P, _I, _P],
    'rectify_tables_launch': [_P] + [_I] * 5 + [_P] * 4,
    'rectify_pack_map_launch': [_P, _I, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``name`` of ``csrc/rectify.cu``, with its
    signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = getattr(load_library('rectify'), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn
