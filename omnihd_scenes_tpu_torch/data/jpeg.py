"""JPEG decode and encode for the camera feed.

* :func:`entropy_decode` (list of bitstreams -> their DCT coefficients
  on the host): libjpeg's baseline Huffman decode, one native call for
  the batch on ``min(images, os.cpu_count())`` threads
  (``csrc/host_ops.cpp``, ``data/native.py``), straight into one int16
  buffer, pinned when it is bound for the card.  Entropy decoding is
  serial within a stream; nvJPEG's default backend runs this stage on the
  host too.
* :func:`decode_jpeg_planes` (list of bitstreams -> each one's Y, Cb, Cr
  u8 planes on ``device``, :class:`kernels.rectify.Planes`): the entropy
  decode, the coefficients' upload, then one launch of the IDCT kernel
  (``kernels/jpeg_idct.py``: libjpeg's ``jpeg_idct_islow``; its plain
  version on the CPU).  The planes are views of the padded component
  planes, cut to libjpeg's ``downsampled_height`` / ``_width``.
* :func:`decode_jpegs` (list of bitstreams -> list of (h, w, 3) u8 BGR
  tensors on ``device``): the planes, then libjpeg's fancy chroma
  upsampling and colour tables (``kernels.rectify.planes_to_bgr``; the
  camera feed fuses them into ``rectify`` instead).
* :func:`encode_jpeg` (one (h, w, 3) u8 BGR image -> bytes) at
  ``cv2.imwrite``'s defaults, quality 95 with 4:2:0 chroma: on a CUDA
  device ``nvjpegEncodeImage`` (``kernels/csrc/nvjpeg.cpp``), on the CPU
  ``cv2.imencode``.
* :func:`nvjpeg_decode_planes`: nvJPEG's batched planar decode, kept only
  as the yardstick a chip run times the decode against; no path calls
  it.

Every step is libjpeg's integer arithmetic (islow IDCT, fancy
upsampling, ``jdcolor.c``'s tables), so the card's pixels and the CPU's
equal ``cv2.imdecode``'s (the JAX package's ``cv2.imread``) bit for bit.
What the decode does not take is refused with an error before any CUDA
call: a progressive or other non-baseline frame, one that is not three
8-bit components, a non-interleaved scan, an RGB-coded frame, or a
chroma sampling other than 4:4:4, 4:2:2 and 4:2:0; and a truncated or
corrupt stream (bad Huffman code, missing restart marker, data running
out), which libjpeg decodes with a warning, filling what is missing.
Only the process that owns the card decodes (data workers never touch
CUDA).  :data:`decode_jpeg_planes.calls` counts the batched decodes,
:data:`nvjpeg_decode_planes.calls` nvJPEG's.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from omnihd_scenes_tpu_torch.kernels.rectify import (CHROMA_420, CHROMA_422,
                                                     CHROMA_444, Planes,
                                                     chroma_shape,
                                                     planes_to_bgr)

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


class Coefficients(NamedTuple):
    """A batch's entropy-decoded JPEGs on the host."""
    coefs: torch.Tensor      # (total,) int16, 64 a block, natural order
    quant: torch.Tensor      # (3 n, 64) int32, natural order
    # (3 n, 5) int64 per component (Y, Cb, Cr of each image): first
    # block, block rows, block columns, downsampled height, width.
    comps: np.ndarray
    modes: List[int]         # each image's chroma mode


def entropy_decode(blobs: Sequence, pin: bool = False,
                   threads: Optional[int] = None) -> Coefficients:
    """Huffman-decode baseline JPEGs (u8 arrays) into one int16 buffer
    (pinned when ``pin``), on ``threads`` threads (default ``min(images,
    os.cpu_count())``); the result does not depend on the count.  Raises
    on what the card's decode does not take."""
    from omnihd_scenes_tpu_torch.data import native

    arrays = [np.ascontiguousarray(b, np.uint8) for b in blobs]
    headers = [jpeg_header(a) for a in arrays]
    check_card_decodable(headers)
    n = len(arrays)
    geom = native.jpeg_geometry(arrays)
    comps = np.zeros((3 * n, 5), np.int64)
    comps[:, 1:] = geom[:, 4:].reshape(3 * n, 4)
    blocks = comps[:, 1] * comps[:, 2]
    comps[1:, 0] = np.cumsum(blocks)[:-1]
    total = int(blocks.sum()) * 64
    coefs = torch.empty(total, dtype=torch.int16, pin_memory=pin)
    quant = torch.empty((3 * n, 64), dtype=torch.int32, pin_memory=pin)
    if threads is None:
        threads = min(n, os.cpu_count() or 1)
    native.jpeg_decode_coefficients(arrays, coefs.data_ptr(),
                                    comps[:, 0].reshape(n, 3) * 64,
                                    quant.numpy().reshape(n, 3, 64), threads)
    return Coefficients(coefs, quant, comps, [h.chroma for h in headers])


def planes_of(buffer: torch.Tensor, c: Coefficients) -> List[Planes]:
    """Each image's planes as views of the IDCT's output buffer, cut to
    libjpeg's downsampled extent."""
    out = []
    views = []
    for first, rows, cols, dh, dw in c.comps.tolist():
        plane = buffer[first * 64:(first + rows * cols) * 64].view(
            rows * 8, cols * 8)
        views.append(plane[:dh, :dw])
    for i, mode in enumerate(c.modes):
        out.append(Planes(*views[3 * i:3 * i + 3], mode))
    return out


def decode_jpeg_planes(blobs: Sequence, device,
                       threads: Optional[int] = None) -> List[Planes]:
    """Decode JPEG bitstreams (u8 arrays) to their planes on ``device``:
    the host entropy decode, the upload of the coefficients (pinned,
    without a host wait) and one IDCT launch (its plain version on the
    CPU)."""
    from omnihd_scenes_tpu_torch.kernels.jpeg_idct import jpeg_idct

    device = torch.device(device)
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no JPEG decode for device {device}')
    if len(blobs) == 0:
        return []
    c = entropy_decode(blobs, pin=device.type == 'cuda', threads=threads)
    coefs = c.coefs.to(device, non_blocking=True)
    quant = c.quant.to(device, non_blocking=True)
    planes = planes_of(jpeg_idct(coefs, quant, c.comps), c)
    decode_jpeg_planes.calls += 1
    return planes


decode_jpeg_planes.calls = 0


def decode_jpegs(blobs: Sequence, device,
                 threads: Optional[int] = None) -> List[torch.Tensor]:
    """Decode JPEG bitstreams (u8 arrays) to (h, w, 3) u8 BGR tensors on
    ``device``, equal to ``cv2.imdecode``'s."""
    planes = decode_jpeg_planes(blobs, device, threads)
    return planes_to_bgr(planes) if planes else []


def nvjpeg_decode_planes(blobs: Sequence, device) -> List[Planes]:
    """nvJPEG's batched planar decode of JPEG bitstreams on a CUDA device
    (one ``nvjpegDecodeBatched`` call, ``kernels/csrc/nvjpeg.cpp``), the
    library yardstick of :func:`decode_jpeg_planes`; its IDCT is not
    libjpeg's.  No path calls it."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'no nvJPEG decode for device {device}')
    arrays = [np.ascontiguousarray(b, np.uint8) for b in blobs]
    headers = [jpeg_header(a) for a in arrays]
    check_card_decodable(headers)
    n = len(arrays)
    if n == 0:
        return []
    planes, channels, pitches = [], [], []
    for h in headers:
        ch, cw = chroma_shape((h.height, h.width), h.chroma)
        p = Planes(torch.empty((h.height, h.width), dtype=torch.uint8,
                               device=device),
                   torch.empty((ch, cw), dtype=torch.uint8, device=device),
                   torch.empty((ch, cw), dtype=torch.uint8, device=device),
                   h.chroma)
        channels += [t.data_ptr() for t in p[:3]]
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
    nvjpeg_decode_planes.calls += 1
    return planes


nvjpeg_decode_planes.calls = 0


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
