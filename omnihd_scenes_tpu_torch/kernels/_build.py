"""Build the CUDA kernels from the sources in ``csrc/`` at first use.

Each kernel file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  Builds go
to ``_build/<name>-<hash>/`` next to this file, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``), the flags and ``nvcc
--version``, so an edited source or another toolkit rebuilds and an
unchanged one is reused.  ``nvcc``'s own output (``-Xptxas -v``: registers, shared
memory and spills per kernel) is kept beside the library as ``nvcc.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the toolkit's
    default install prefix; raises if there is none."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))
    candidate = home / 'bin' / 'nvcc'
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        'nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built '
        'from source at first use and need the CUDA toolkit')


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version`` of the toolkit the kernels are built with."""
    return subprocess.run([nvcc_path(), '--version'], capture_output=True,
                          text=True, check=True).stdout


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by the source, the headers,
    the flags and the toolkit, so a change of any of them rebuilds."""
    source = b''.join(p.read_bytes() for p in
                      [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))])
    key = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode()
                         + nvcc_version().encode())
    return BUILD_DIR / f'{name}-{key.hexdigest()[:16]}' / f'lib{name}.so'


def compile_library(name: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
           str(CSRC / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (out.parent / 'nvcc.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed with code {proc.returncode} on '
                           f'{name}.cu:\n{proc.stderr}')
    os.replace(tmp, out)            # readers never see a partial library


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, built first if needed."""
    out = library_path(name)
    if not out.exists():
        compile_library(name, out)
    return ctypes.CDLL(str(out))
