"""ctypes bindings to the port's native radar decode
(``omnihd_scenes_tpu_torch/csrc/host_ops.cpp``).

Counterpart of ``omnihd_scenes_tpu/data/native.py`` for its radar part:
``g++ -O3 -shared -fPIC`` builds the library at first use into
``kernels/_build/host_ops-<hash>/`` (gitignored), keyed by a hash of the
source, the flags and ``g++ --version``, written under a temporary name and
renamed, so concurrent first users (the worker pool's processes, parallel
test workers) never load a partial file.  The C functions touch no Python
object, and ctypes releases the interpreter lock around each call, so a
decode overlaps the other threads of the process.

Unlike the JAX package, nothing falls back: ``radar_loading.
load_radar_sweep(use_native=True)`` raises when the library cannot be
built or loaded, or the sweep cannot be read; ``use_native=False`` is the
explicit NumPy path.
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
FLAGS = ('-O3', '-shared', '-fPIC')
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
    return lib


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

