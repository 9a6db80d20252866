"""Build the CUDA kernels from the sources in ``csrc/`` at first use.

Each kernel file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`; a source
that calls a library of the toolkit (``nvjpeg.cpp`` and ``libnvjpeg``)
links it from ``$CUDA_HOME/lib64`` with that directory as its run path.
Builds go to ``_build/<name>-<hash>/`` next to this file, keyed by a hash
of the source, the shared headers (``csrc/*.cuh``), the flags, the linked
libraries and ``nvcc --version``, so an edited source or another toolkit
rebuilds and an unchanged one is reused.  ``nvcc``'s own output (``-Xptxas -v``: registers, shared
memory and spills per kernel) is kept beside the library as ``nvcc.log``.
A build is the span ``setup.kernel_build`` and adds to the counter
``kernels.builds``; each library loaded adds to ``kernels.loads``
(``utils/timing.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from omnihd_scenes_tpu_torch.utils.timing import count, span

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# Sources that are not ``<name>.cu``, and the toolkit libraries a source
# links.
SOURCES = {'nvjpeg': 'nvjpeg.cpp'}
LIBRARIES = {'nvjpeg': ('nvjpeg',)}


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


def source_path(name: str) -> Path:
    return CSRC / SOURCES.get(name, f'{name}.cu')


def link_flags(name: str) -> list:
    """``-L`` / ``-l`` / run path of the toolkit libraries ``name`` links."""
    libs = LIBRARIES.get(name, ())
    if not libs:
        return []
    lib_dir = Path(nvcc_path()).resolve().parent.parent / 'lib64'
    return [f'-L{lib_dir}', *(f'-l{lib}' for lib in libs),
            '-Xlinker', f'-rpath={lib_dir}']


def library_path(name: str) -> Path:
    """Where ``name``'s source is built: keyed by the source, the headers,
    the flags, the linked libraries and the toolkit, so a change of any of
    them rebuilds."""
    source = b''.join(p.read_bytes() for p in
                      [source_path(name), *sorted(CSRC.glob('*.cuh'))])
    key = hashlib.sha256(source + ' '.join(NVCC_FLAGS + tuple(
        link_flags(name))).encode() + nvcc_version().encode())
    return BUILD_DIR / f'{name}-{key.hexdigest()[:16]}' / f'lib{name}.so'


@span('setup.kernel_build')
def compile_library(name: str, out: Path) -> None:
    count('kernels.builds')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(source_path(name)),
           *link_flags(name)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (out.parent / 'nvcc.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed with code {proc.returncode} on '
                           f'{source_path(name).name}:\n{proc.stderr}')
    os.replace(tmp, out)            # readers never see a partial library


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu`` (or its :data:`SOURCES` entry),
    built first if needed."""
    out = library_path(name)
    if not out.exists():
        compile_library(name, out)
    count('kernels.loads')
    return ctypes.CDLL(str(out))


def build_libraries(names) -> None:
    """Build every missing library of ``names`` at once, one ``nvcc`` each
    (a data-parallel run's rank 0 does this before the others load
    them)."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(load_library, names))
