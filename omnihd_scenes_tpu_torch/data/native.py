"""ctypes bindings to the port's native host ops
(``omnihd_scenes_tpu_torch/csrc/host_ops.cpp``): the radar sweep decode,
the greedy rotated NMS (``ops/nms_host.py``) and the baseline JPEG
entropy decode of the camera feed (``data/jpeg.py``).

Counterpart of ``omnihd_scenes_tpu/data/native.py`` for the first two
(the JPEG decode has none: the JAX package decodes with OpenCV):
``g++ -O3 -shared -fPIC -pthread`` builds the library at first use into
``kernels/_build/host_ops-<hash>/`` (gitignored), keyed by a hash of the
source, the flags and ``g++ --version``, written under a temporary name and
renamed, so concurrent first users (the worker pool's processes, parallel
test workers) never load a partial file.  The C functions touch no Python
object, and ctypes releases the interpreter lock around each call, so a
decode overlaps the other threads of the process.

Unlike the JAX package, nothing falls back: ``radar_loading.
load_radar_sweep(use_native=True)`` and the host NMS raise when the
library cannot be built or loaded, or the sweep cannot be read;
``use_native=False`` is the radar decode's explicit NumPy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'host_ops.cpp'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'kernels' / '_build'
FLAGS = ('-O3', '-shared', '-fPIC', '-pthread')
ROW = 8                                  # raw radar row: 8 float32


def library_path() -> Path:
    """Where the library is built: keyed by source, flags and compiler."""
    version = subprocess.run(['g++', '--version'], capture_output=True,
                             text=True, check=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes() + ' '.join(FLAGS).encode()
                         + version.encode()).hexdigest()[:16]
    return BUILD_DIR / f'host_ops-{key}' / 'libhost_ops.so'


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The native library, built first if needed; raises if it cannot be
    built or loaded."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        proc = subprocess.run(['g++', *FLAGS, '-o', str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed with code {proc.returncode} on '
                               f'{SOURCE.name}:\n{proc.stderr}')
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    lib.load_f32_bin.argtypes = [ctypes.c_char_p, f32p, ctypes.c_long]
    lib.load_f32_bin.restype = ctypes.c_long
    lib.radar_compensate.argtypes = [f32p, ctypes.c_long, f64p, f64p, f64p,
                                     f64p, ctypes.c_double, ctypes.c_double,
                                     f32p]
    lib.radar_compensate.restype = None
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    lib.nms_rotated_multiclass.argtypes = [
        f32p, f32p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_double, ctypes.c_double, ctypes.c_long, f32p, f32p, i32p]
    lib.nms_rotated_multiclass.restype = ctypes.c_long
    ptr = ctypes.c_void_p
    lib.jpeg_geometry.argtypes = [ctypes.c_long, ptr, ptr, ptr, ptr]
    lib.jpeg_geometry.restype = ctypes.c_long
    lib.jpeg_decode_coefficients.argtypes = [ctypes.c_long, ptr, ptr, ptr,
                                             ptr, ptr, ctypes.c_long, ptr]
    lib.jpeg_decode_coefficients.restype = ctypes.c_long
    return lib


JPEG_ERR_LEN = 256                       # host_ops.cpp kErrLen


def _jpeg_streams(arrays):
    """ctypes arrays of the bitstreams' pointers and lengths."""
    n = len(arrays)
    return ((ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays]),
            (ctypes.c_int64 * n)(*[a.nbytes for a in arrays]))


def _jpeg_raise(errors, n: int) -> None:
    for i in range(n):
        msg = errors[i * JPEG_ERR_LEN:(i + 1) * JPEG_ERR_LEN].split(
            b'\0', 1)[0]
        if msg:
            raise ValueError(f'JPEG {i}: {msg.decode()}')


def jpeg_geometry(arrays) -> np.ndarray:
    """(n, 16) int32 frame geometry of baseline JPEGs (contiguous u8
    arrays): height, width, SOF marker, components, then per component
    (Y, Cb, Cr) its block rows and columns, padded to whole MCUs, and
    libjpeg's ``downsampled_height`` / ``downsampled_width``.  Raises a
    ValueError on the first stream the decode refuses."""
    n = len(arrays)
    geom = np.zeros((n, 16), np.int32)
    errors = ctypes.create_string_buffer(max(n, 1) * JPEG_ERR_LEN)
    if get_lib().jpeg_geometry(n, *_jpeg_streams(arrays),
                               geom.ctypes.data, errors):
        _jpeg_raise(errors.raw, n)
    return geom


def jpeg_decode_coefficients(arrays, coefs_ptr: int, offsets: np.ndarray,
                             quant: np.ndarray, threads: int) -> None:
    """Entropy-decode baseline JPEGs on ``threads`` threads, one call for
    the batch: image i's component c (Y, Cb, Cr) goes to the int16 buffer
    at ``coefs_ptr`` from element ``offsets[i, c]`` on, its block grid
    (:func:`jpeg_geometry`) row-major, 64 coefficients a block in natural
    order; its quantisation table to ``quant[i, c]`` (int32, natural
    order).  Raises a ValueError on a stream it cannot decode."""
    n = len(arrays)
    offsets = np.ascontiguousarray(offsets, np.int64)
    assert offsets.shape == (n, 3) and quant.shape == (n, 3, 64) \
        and quant.dtype == np.int32 and quant.flags.c_contiguous
    errors = ctypes.create_string_buffer(max(n, 1) * JPEG_ERR_LEN)
    if get_lib().jpeg_decode_coefficients(
            n, *_jpeg_streams(arrays), coefs_ptr, offsets.ctypes.data,
            quant.ctypes.data, int(threads), errors):
        _jpeg_raise(errors.raw, n)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).reshape(-1)


def radar_sweep_native(path: str, inv_s2e_rot: np.ndarray,
                       s2l_rot: np.ndarray, s2l_trans: np.ndarray,
                       ego_vel: np.ndarray, time_diff: float,
                       radar_id: float) -> np.ndarray:
    """Load + compensate one raw radar sweep -> (N, 10) float32 rows (the
    layout of ``radar_loading.load_radar_sweep``)."""
    lib = get_lib()
    n_floats = os.path.getsize(path) // 4
    raw = np.empty(max(n_floats, 1), np.float32)
    n = lib.load_f32_bin(path.encode(), raw, n_floats)
    if n < 0:
        raise OSError(f'cannot read radar sweep {path}')
    n //= ROW
    out = np.empty((n, 10), np.float32)
    lib.radar_compensate(np.ascontiguousarray(raw[:n * ROW]), n,
                         _f64(inv_s2e_rot), _f64(s2l_rot), _f64(s2l_trans),
                         _f64(ego_vel), float(time_diff), float(radar_id),
                         out)
    return out

