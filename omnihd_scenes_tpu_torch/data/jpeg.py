"""JPEG decode and encode: batched on the card through nvJPEG, with
OpenCV as the plain form on the CPU.

* :func:`decode_jpeg_planes` (list of bitstreams -> the (Y, Cb, Cr) u8
  planes of each on a CUDA device, and each one's chroma mode): one
  ``nvjpegDecodeBatched`` call (``kernels/csrc/nvjpeg.cpp``) into
  tensors PyTorch allocates, on the current stream.
* :func:`decode_jpegs` (list of bitstreams -> list of (h, w, 3) u8 BGR
  tensors on ``device``): on a CUDA device :func:`decode_jpeg_planes`
  then one launch of the rectify kernel's ``ycbcr_to_bgr`` pass, which
  upsamples the chroma and converts to BGR as libjpeg does; on the CPU
  ``cv2.imdecode``, which the JAX package's ``cv2.imread`` runs.
* :func:`encode_jpeg` (one (h, w, 3) u8 BGR image -> bytes) at
  ``cv2.imwrite``'s defaults, quality 95 with 4:2:0 chroma: on a CUDA
  device ``nvjpegEncodeImage``, on the CPU ``cv2.imencode``.

nvJPEG's IDCT is not libjpeg-turbo's, so the card's pixels are close to
OpenCV's, not equal (``tests/torch_port_fixtures/jpeg`` bounds the gap).
nvJPEG's own interleaved BGR output upsamples 4:2:0 chroma otherwise
than libjpeg's "fancy" filter and lands far outside those bounds on
noisy chroma (PERF.md), hence the planes and the libjpeg steps after
them.  What the card's batched path does not decode is refused with an
error before any CUDA call: a progressive or non-baseline-DCT stream,
one that is not three components, or a chroma sampling other than 4:4:4,
4:2:2 and 4:2:0.  The nvJPEG context (handle, decode and encode states)
is made once per process and device; only the process that owns the card
decodes (data workers never touch CUDA).
:data:`decode_jpeg_planes.calls` counts the card's batched decode calls.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from omnihd_scenes_tpu_torch.kernels.rectify import (CHROMA_420, CHROMA_422,
                                                     CHROMA_444, chroma_shape,
                                                     ycbcr_to_bgr)

QUALITY = 95                 # cv2.imwrite's default IMWRITE_JPEG_QUALITY
_BUFFER_TOO_SMALL = 2000000
_NVJPEG_BASE = 1000000
_LOCK = threading.Lock()
# Start-of-frame markers: 0xC0-0xCF but DHT (C4), JPG (C8), DAC (CC).
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_BASELINE_SOF = {0xC0, 0xC1}


class JpegHeader(NamedTuple):
    height: int
    width: int
    components: int
    marker: int              # the SOF marker: 0xC0 baseline, 0xC2 progressive
    sampling: tuple          # (H, V) sampling factors per component

    @property
    def baseline(self) -> bool:
        return self.marker in _BASELINE_SOF

    @property
    def chroma(self):
        """The rectify kernel's chroma mode of a 3-component frame
        (``rectify.CHROMA_444`` / ``_422`` / ``_420``), or None."""
        if self.components != 3 or self.sampling[1] != self.sampling[2]:
            return None
        (yh, yv), (ch, cv) = self.sampling[0], self.sampling[1]
        if yh % ch or yv % cv:
            return None
        return {(1, 1): CHROMA_444, (2, 1): CHROMA_422,
                (2, 2): CHROMA_420}.get((yh // ch, yv // cv))


def jpeg_header(data) -> JpegHeader:
    """The frame header of a JPEG bitstream (u8 array or bytes): walks the
    marker segments from SOI to the first start-of-frame."""
    b = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    n = len(b)
    if n < 4 or b[0] != 0xFF or b[1] != 0xD8:
        raise ValueError('not a JPEG bitstream (no SOI marker)')
    i = 2
    while i + 4 <= n:
        if b[i] != 0xFF:
            raise ValueError(f'corrupt JPEG: no marker at byte {i}')
        marker = int(b[i + 1])
        if marker == 0xFF:                  # fill byte
            i += 1
            continue
        length = (int(b[i + 2]) << 8) | int(b[i + 3])
        if marker in _SOF:
            nc = int(b[i + 9]) if i + 10 <= n else 0
            if nc == 0 or i + 10 + 3 * nc > n:
                break
            h = (int(b[i + 5]) << 8) | int(b[i + 6])
            w = (int(b[i + 7]) << 8) | int(b[i + 8])
            hv = [int(b[i + 11 + 3 * k]) for k in range(nc)]
            return JpegHeader(h, w, nc, marker,
                              tuple((v >> 4, v & 15) for v in hv))
        if marker == 0xDA:                  # start of scan before a frame
            break
        i += 2 + length
    raise ValueError('corrupt JPEG: no start-of-frame segment')


def check_card_decodable(headers: Sequence[JpegHeader]) -> None:
    """Raise on what the card's batched decode does not take."""
    for k, h in enumerate(headers):
        if not h.baseline:
            raise ValueError(
                f'JPEG {k}: SOF marker 0x{h.marker:02X} (progressive or '
                'other non-baseline coding) is not decoded on the card; '
                're-encode it as baseline or decode on the host')
        if h.components != 3:
            raise ValueError(f'JPEG {k} has {h.components} components; the '
                             'card decodes three-component (colour) images')
        if h.chroma is None:
            raise ValueError(f'JPEG {k}: chroma sampling {h.sampling} is '
                             'not decoded on the card (4:4:4, 4:2:2 and '
                             '4:2:0 are)')


def _decode_cpu(blobs) -> List[torch.Tensor]:
    from omnihd_scenes_tpu_torch.data.image_loading import require_cv2

    cv2 = require_cv2()
    out = []
    for k, blob in enumerate(blobs):
        img = cv2.imdecode(np.asarray(blob, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f'JPEG {k} could not be decoded')
        out.append(torch.from_numpy(img))
    return out


def decode_jpeg_planes(blobs: Sequence, device):
    """Decode JPEG bitstreams (u8 arrays) on a CUDA device -> ([(Y, Cb, Cr)
    u8 planes] with the chroma planes of :func:`kernels.rectify.
    chroma_shape`, [chroma mode]): one nvJPEG batched decode; raises on
    what it cannot decode, or on an nvJPEG error."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'no planar JPEG decode for device {device}')
    arrays = [np.ascontiguousarray(b, np.uint8) for b in blobs]
    headers = [jpeg_header(a) for a in arrays]
    check_card_decodable(headers)
    n = len(arrays)
    if n == 0:
        return [], []
    planes, channels, pitches = [], [], []
    for h in headers:
        ch, cw = chroma_shape((h.height, h.width), h.chroma)
        p = (torch.empty((h.height, h.width), dtype=torch.uint8,
                         device=device),
             torch.empty((ch, cw), dtype=torch.uint8, device=device),
             torch.empty((ch, cw), dtype=torch.uint8, device=device))
        channels += [t.data_ptr() for t in p]
        pitches += [h.width, cw, cw]
        planes.append(p)
    data = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    lengths = (ctypes.c_size_t * n)(*[a.nbytes for a in arrays])
    dst = (ctypes.c_void_p * (3 * n))(*channels)
    pitch = (ctypes.c_int * (3 * n))(*pitches)
    lib = _library()
    with _LOCK, torch.cuda.device(device):
        ctx = _context(device.index if device.index is not None
                       else torch.cuda.current_device())
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nvjpeg_decode(ctx, n, data, lengths, dst, pitch, stream)
    _raise_on_error('nvjpegDecodeBatched', err)
    decode_jpeg_planes.calls += 1
    return planes, [h.chroma for h in headers]


decode_jpeg_planes.calls = 0


def decode_jpegs(blobs: Sequence, device) -> List[torch.Tensor]:
    """Decode JPEG bitstreams (u8 arrays) to (h, w, 3) u8 BGR tensors on
    ``device``: :func:`decode_jpeg_planes` and the ``ycbcr_to_bgr`` pass
    on a CUDA device, ``cv2.imdecode`` on the CPU."""
    device = torch.device(device)
    if device.type == 'cpu':
        return _decode_cpu(blobs)
    planes, modes = decode_jpeg_planes(blobs, device)
    return ycbcr_to_bgr(planes, modes) if planes else []


def encode_jpeg(img, device='cpu') -> bytes:
    """One (h, w, 3) u8 BGR image (array or tensor) -> JPEG bytes at
    ``cv2.imwrite``'s defaults (quality 95, 4:2:0): ``cv2.imencode`` on the
    CPU, nvJPEG's encoder on a CUDA device."""
    device = torch.device(device)
    if device.type == 'cpu':
        from omnihd_scenes_tpu_torch.data.image_loading import require_cv2

        cv2 = require_cv2()
        ok, buf = cv2.imencode('.jpg', np.asarray(img, np.uint8))
        if not ok:
            raise ValueError('cv2.imencode failed')
        return buf.tobytes()
    if device.type != 'cuda':
        raise ValueError(f'no JPEG encode for device {device}')
    t = torch.as_tensor(img)
    if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.uint8:
        raise ValueError(f'encode_jpeg takes an (h, w, 3) uint8 image, got '
                         f'{tuple(t.shape)} {t.dtype}')
    t = t.to(device).contiguous()
    h, w = t.shape[:2]
    size = ctypes.c_size_t(h * w * 3 + 65536)
    lib = _library()
    while True:
        buf = ctypes.create_string_buffer(size.value)
        with _LOCK, torch.cuda.device(device):
            ctx = _context(device.index if device.index is not None
                           else torch.cuda.current_device())
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.nvjpeg_encode_bgri(ctx, t.data_ptr(), w, h, QUALITY,
                                         buf, ctypes.byref(size), stream)
        if err != _BUFFER_TOO_SMALL:
            break
    _raise_on_error('nvjpegEncodeImage', err)
    return buf.raw[:size.value]


def _raise_on_error(what: str, err: int) -> None:
    if err == 0:
        return
    if err >= _NVJPEG_BASE:
        raise RuntimeError(f'{what} failed: nvjpegStatus_t '
                           f'{err - _NVJPEG_BASE}')
    raise RuntimeError(f'{what} failed: CUDA error {err}')


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/nvjpeg.cpp``, built and bound at first use."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    lib = load_library('nvjpeg')
    ptr = ctypes.c_void_p
    lib.nvjpeg_create.argtypes = [ctypes.POINTER(ptr)]
    lib.nvjpeg_create.restype = ctypes.c_int
    lib.nvjpeg_destroy.argtypes = [ptr]
    lib.nvjpeg_destroy.restype = None
    lib.nvjpeg_decode.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr, ptr,
                                  ptr]
    lib.nvjpeg_decode.restype = ctypes.c_int
    lib.nvjpeg_encode_bgri.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ptr,
                                       ctypes.POINTER(ctypes.c_size_t), ptr]
    lib.nvjpeg_encode_bgri.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _context(device_index: int) -> ctypes.c_void_p:
    """The process's nvJPEG context on one device, made once (call with
    that device current)."""
    ctx = ctypes.c_void_p()
    _raise_on_error('nvjpegCreateSimple', _library().nvjpeg_create(
        ctypes.byref(ctx)))
    return ctx
