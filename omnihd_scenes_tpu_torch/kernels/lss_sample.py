"""LSS sampling view transform: the CUDA kernel's wrapper and its plain
PyTorch version.

Layouts (one launch covers the whole batch and every camera):

* ``feat`` (B, N, fH, fW, C) and ``depth`` (B, N, fH, fW, D), same dtype;
* ``i_star`` (B, N, fH, nz, NB) int32 — camera n's pass-1 image column
  at (image row j, z, b); b spans ny for ``solve_x`` cameras and nx for
  the others, NB >= that span;
* ``j_star`` / ``kd_star`` (B, N, nz, ny * nx) int32 — camera n's image
  row and depth bin in the camera's own (nz, n_b, n_g) order, i.e.
  (b, g) = (y, x) for ``solve_x`` cameras and (x, y) for side cameras;
* result (B, ny, nx, nz, C).

These are the index fields of ``omnihd_scenes_tpu/ops/lss_project.py:
_sample_indices``; :func:`omnihd_scenes_tpu_torch.ops.lss_project.
sample_fields` packs them.  The CUDA source is ``csrc/lss_sample.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32)}
_MAX_CHANNELS = 256
_MAX_CAMERAS = 32


def _camera_gathers(i_star, j_star, kd_star, solve_x, ny, nx, f_w, d_bins):
    """Per camera n, over the (B, ny, nx, nz) output cells: (n, row,
    column, depth bin) that each cell gathers (clamped into range), the
    cell's word of ``i_star[b, n]`` (flat), whether that word is read (row
    and bin in range) and whether the camera adds (column in range too)."""
    b, _, f_h, nz, nb = i_star.shape
    dev = i_star.device
    y = torch.arange(ny, device=dev).view(ny, 1, 1)
    x = torch.arange(nx, device=dev).view(1, nx, 1)
    z = torch.arange(nz, device=dev).view(1, 1, nz)
    bb = torch.arange(b, device=dev).view(b, 1, 1, 1)
    for n, sx in enumerate(solve_x):
        col, bg = (y, y * nx + x) if sx else (x, x * ny + y)
        cell = z * (ny * nx) + bg                         # (ny, nx, nz)
        j = j_star[:, n].flatten(1)[:, cell]              # (B, ny, nx, nz)
        kd = kd_star[:, n].flatten(1)[:, cell]
        read_i = (j >= 0) & (j < f_h) & (kd >= 0) & (kd < d_bins)
        jc = j.clamp(0, f_h - 1)
        word = (jc * nz + z) * nb + col
        i = i_star[:, n].flatten(1)[bb, word]
        ok = read_i & (i >= 0) & (i < f_w)
        yield (n, jc, i.clamp(0, f_w - 1), kd.clamp(0, d_bins - 1), word,
               read_i, ok)


def lss_sample_reference(feat, depth, i_star, j_star, kd_star,
                         solve_x: Sequence[bool], ny: int, nx: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain gather-multiply-sum: what the kernel computes, in f32, with
    the cameras summed in order."""
    b, _, _, f_w, c_ch = feat.shape
    nz = j_star.shape[2]
    dev = feat.device
    bb = torch.arange(b, device=dev).view(b, 1, 1, 1)
    acc = torch.zeros((b, ny, nx, nz, c_ch), dtype=torch.float32, device=dev)
    for n, jc, ic, kdc, _, _, ok in _camera_gathers(
            i_star, j_star, kd_star, solve_x, ny, nx, f_w, depth.shape[-1]):
        w = depth[bb, n, jc, ic, kdc].float() * ok
        acc += feat[bb, n, jc, ic].float() * w[..., None]
    return acc.to(out_dtype)


def lss_sample_bytes(feat, depth, i_star, j_star, kd_star,
                     solve_x: Sequence[bool], ny: int, nx: int,
                     out_dtype: torch.dtype) -> int:
    """Bytes that the function must move on these inputs, each needed
    element once: all of ``j_star`` and ``kd_star`` (every cell reads its
    row and depth bin for every camera), each ``i_star`` word that a cell
    with its row and bin in range reads, each depth value and feature row
    that a contributing cell gathers, and the output written once."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    words_per_image = f_h * i_star.shape[3] * i_star.shape[4]

    def distinct(index, mask):
        return int(torch.unique(index.long()[mask]).numel())

    nbytes = 4 * (j_star.numel() + kd_star.numel()) \
        + b * ny * nx * j_star.shape[2] * c_ch * out_dtype.itemsize
    for _, jc, ic, kdc, word, read_i, ok in _camera_gathers(
            i_star, j_star, kd_star, solve_x, ny, nx, f_w, depth.shape[-1]):
        pix = (bb * f_h + jc.long()) * f_w + ic
        nbytes += 4 * distinct(bb * words_per_image + word, read_i)
        nbytes += feat.element_size() * c_ch * distinct(pix, ok)
        nbytes += depth.element_size() * distinct(pix * depth.shape[-1] + kdc,
                                                  ok)
    return nbytes


def _check_shapes(feat, depth, i_star, j_star, kd_star, solve_x, ny, nx):
    if feat.dim() != 5 or depth.dim() != 5:
        raise ValueError(f'feat/depth must be (B, N, fH, fW, C/D), got '
                         f'{tuple(feat.shape)} / {tuple(depth.shape)}')
    b, n_cams, f_h, f_w, _ = feat.shape
    if tuple(depth.shape[:4]) != (b, n_cams, f_h, f_w):
        raise ValueError(f'depth {tuple(depth.shape)} does not match feat '
                         f'{tuple(feat.shape)}')
    if len(solve_x) != n_cams:
        raise ValueError(f'{len(solve_x)} solve_x flags for {n_cams} cameras')
    if j_star.dim() != 4 or tuple(j_star.shape[:2]) != (b, n_cams) \
            or j_star.shape[3] != ny * nx or kd_star.shape != j_star.shape:
        raise ValueError(f'j_star/kd_star must be (B, N, nz, ny*nx) = '
                         f'({b}, {n_cams}, nz, {ny * nx}), got '
                         f'{tuple(j_star.shape)} / {tuple(kd_star.shape)}')
    nz = j_star.shape[2]
    span = max(ny if sx else nx for sx in solve_x)
    if i_star.dim() != 5 or tuple(i_star.shape[:4]) != (b, n_cams, f_h, nz) \
            or i_star.shape[4] < span:
        raise ValueError(f'i_star must be (B, N, fH, nz, >= {span}), got '
                         f'{tuple(i_star.shape)}')


def lss_sample(feat: torch.Tensor, depth: torch.Tensor, i_star: torch.Tensor,
               j_star: torch.Tensor, kd_star: torch.Tensor,
               solve_x: Sequence[bool], ny: int, nx: int,
               out_dtype: torch.dtype = None) -> torch.Tensor:
    """Sample depth-weighted camera features into the BEV grid.

    A CPU tensor goes to :func:`lss_sample_reference`; a CUDA tensor
    launches the kernel (bf16 or f32 inputs; bf16 -> bf16, bf16 -> f32 or
    f32 -> f32) or raises.  Returns (B, ny, nx, nz, C) in ``out_dtype``
    (default: ``feat.dtype``).
    """
    solve_x = tuple(bool(s) for s in solve_x)
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    _check_shapes(feat, depth, i_star, j_star, kd_star, solve_x, ny, nx)
    if feat.device.type == 'cpu':
        return lss_sample_reference(feat, depth, i_star, j_star, kd_star,
                                    solve_x, ny, nx, out_dtype)
    if feat.device.type != 'cuda':
        raise ValueError(f'no lss_sample for device {feat.device}')

    tensors = (feat, depth, i_star, j_star, kd_star)
    if any(t.device != feat.device for t in tensors):
        raise ValueError('lss_sample inputs must share one device')
    if (feat.dtype, out_dtype) not in _SUPPORTED or depth.dtype != feat.dtype:
        raise TypeError(f'lss_sample kernel takes {sorted(map(str, _SUPPORTED))}'
                        f' (in, out) dtypes, got feat {feat.dtype}, depth '
                        f'{depth.dtype}, out {out_dtype}')
    if any(t.dtype != torch.int32 for t in (i_star, j_star, kd_star)):
        raise TypeError('lss_sample index fields must be int32')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('lss_sample inputs must be contiguous')
    b, n_cams, f_h, f_w, c_ch = feat.shape
    if c_ch % 2 or c_ch > _MAX_CHANNELS or n_cams > _MAX_CAMERAS:
        raise ValueError(f'lss_sample kernel needs an even C <= '
                         f'{_MAX_CHANNELS} and <= {_MAX_CAMERAS} cameras, got '
                         f'C={c_ch}, N={n_cams}')
    if feat.data_ptr() % 8:
        raise ValueError('feat must be 8-byte aligned for paired loads')
    nz = j_star.shape[2]
    out = torch.empty((b, ny, nx, nz, c_ch), dtype=out_dtype,
                      device=feat.device)
    mask = sum(1 << n for n, sx in enumerate(solve_x) if sx)

    fn = _kernel()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), depth.data_ptr(), i_star.data_ptr(),
                 j_star.data_ptr(), kd_star.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[feat.dtype], _DTYPE_CODES[out_dtype], mask,
                 b, n_cams, f_h, f_w, c_ch, depth.shape[-1], nz, ny, nx,
                 i_star.shape[4], stream)
    if err != 0:
        raise RuntimeError(f'lss_sample kernel launch failed: CUDA error '
                           f'{err}')
    lss_sample.launches += 1
    return out


lss_sample.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = load_library('lss_sample').lss_sample_forward
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 6 + [i32, i32, ctypes.c_uint32] + [i32] * 10 + [ptr]
    fn.restype = i32
    return fn
