"""LSS sampling view transform: the CUDA kernels' wrappers and their plain
PyTorch versions, and the index fields the plain versions compute.

Three entry points of ``csrc/lss_sample.cu``; the first two share one
gather kernel:

* :func:`lss_sample_bev` (the main path) takes the camera geometry, as the
  JAX ``sample_bev_pallas`` does: ``minv`` (B, N, 3, 3) and ``mt`` (B, N,
  3) f32 (lidar -> image, :func:`omnihd_scenes_tpu_torch.ops.lss_project.
  camera_geometry`) and a :class:`_Geom`.  The kernel computes the index
  fields itself (``csrc/lss_geom.cuh``), op for op as
  :func:`_sample_indices` does; its plain version is
  :func:`geometry_fields` + :func:`lss_sample_reference`.
* :func:`lss_sample` takes precomputed int32 index fields, so that tests
  can feed the gather core any fields.
* :func:`lss_sample_bev_backward` is the gradient of
  :func:`lss_sample_bev` for feat and depth: the same index fields
  (computed by the same ``csrc/lss_geom.cuh``), the (cell, camera) pairs
  bucketed by pixel and each pixel's gradient summed over its bucket in
  cell order.  Its plain version is
  :func:`lss_sample_bev_backward_reference` (``index_add_``).
  :class:`LSSSampleBEV` is the ``torch.autograd.Function`` of the pair,
  the counterpart of the ``jax.custom_vjp`` of
  ``omnihd_scenes_tpu/ops/pallas_splat.py:246-261``.  ``minv`` and ``mt``
  get no gradient: they reach the output only through rounded indices.

Layouts (one launch covers the whole batch and every camera):

* ``feat`` (B, N, fH, fW, C) and ``depth`` (B, N, fH, fW, D), same dtype;
* ``i_star`` (B, N, fH, nz, NB) int32 — camera n's pass-1 image column
  at (image row j, z, b); b spans ny for ``solve_x`` cameras and nx for
  the others, NB >= that span;
* ``j_star`` / ``kd_star`` (B, N, nz, ny * nx) int32 — camera n's image
  row and depth bin in the camera's own (nz, n_b, n_g) order, i.e.
  (b, g) = (y, x) for ``solve_x`` cameras and (x, y) for side cameras;
* per-cell indices (:func:`cell_indices`, the kernel's index dump)
  (B, ny, nx, nz, N) int32: the (j, i, kd) each cell uses per camera, i
  read at row j and -1 where j or kd is out of range;
* result (B, ny, nx, nz, C).

The index fields are those of ``omnihd_scenes_tpu/ops/lss_project.py:
_sample_indices``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

_BIG = 1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32)}
_MAX_CHANNELS = 256
_MAX_CAMERAS = 32
_MAX_NZ = 128


# ---- the index fields (plain PyTorch) --------------------------------------

def _safe_div(a, b, eps=1e-6):
    bs = torch.where(b.abs() < eps,
                     torch.where(b < 0, -eps, eps).to(b.dtype), b)
    return a / bs


def _clean_idx(x, valid):
    """Round a float index to int32, routing invalid/non-finite entries
    to -1."""
    ok = valid & torch.isfinite(x)
    x = torch.where(ok, x, -_BIG)
    return torch.round(x).clamp(-1, _BIG).to(torch.int32)


class _Geom:
    """Static geometry of the image plane and the BEV grid (NumPy f32,
    built exactly as the JAX ``_Geom``)."""

    def __init__(self, image_size, feat_hw, depth_range, bev_start,
                 bev_voxel, bev_nx):
        self.args = tuple(tuple(a) for a in (
            image_size, feat_hw, depth_range, bev_start, bev_voxel, bev_nx))
        self.h_img, self.w_img = image_size
        self.f_h, self.f_w = feat_hw
        self.d0, self.d1, self.dd = depth_range
        self.nx, self.ny, self.nz = (int(v) for v in bev_nx)
        self.v_scale = (self.f_h - 1) / max(self.h_img - 1, 1)
        self.u_scale = (self.f_w - 1) / max(self.w_img - 1, 1)
        self.ys = np.linspace(0, self.h_img - 1, self.f_h, dtype=np.float32)
        self.xc = np.asarray(
            bev_start[0]
            + (np.arange(self.nx, dtype=np.float32) + 0.5) * bev_voxel[0],
            np.float32)
        self.yc = np.asarray(
            bev_start[1]
            + (np.arange(self.ny, dtype=np.float32) + 0.5) * bev_voxel[1],
            np.float32)
        self.zc = np.asarray(
            bev_start[2]
            + (np.arange(self.nz, dtype=np.float32) + 0.5) * bev_voxel[2],
            np.float32)


def _sample_indices(minv, mt, solve_axis_x: bool, g: _Geom):
    """Index fields of cameras that share one orientation.

    ``minv`` (..., 3, 3) and ``mt`` (..., 3) f32, any leading dims.
    Returns, in the JAX layout with the leading dims in front:
        i_star (..., fH, nz, n_b), j_star and kd_star (..., nz, n_b, n_g),
    int32, -1 where invalid.  (n_b, n_g) = (ny, nx) when
    ``solve_axis_x`` else (nx, ny).
    """
    dev = minv.device

    def const(a):
        return torch.from_numpy(a).to(dev)

    if solve_axis_x:
        a_col, bc, gc, fixed = minv[..., 0], g.yc, g.xc, minv[..., 1]
    else:
        a_col, bc, gc, fixed = minv[..., 1], g.xc, g.yc, minv[..., 0]
    bc, gc, zc, ys = const(bc), const(gc), const(g.zc), const(g.ys)
    # cc[..., a, k, b] = fixed_a * bc_b + Minv[a, 2] * zc_k + mt_a
    cc = (fixed[..., None, None] * bc
          + minv[..., 2][..., None, None] * zc[:, None]
          + mt[..., None, None])                         # (..., 3, nz, n_b)
    d_floor = max(1e-3, g.d0 * 0.5)

    def coef(a):                                         # (..., 1, 1, 1)
        return a_col[..., a, None, None, None]

    # pass 1: solve q1/q2 = v_j for the free coordinate s
    v = ys[:, None, None]                                # (fH, 1, 1)
    denom = coef(1) - v * coef(2)
    c0, c1, c2 = (cc[..., a, None, :, :] for a in range(3))
    s_star = _safe_div(v * c2 - c1, denom)               # (..., fH, nz, n_b)
    q2s = coef(2) * s_star + c2
    us = _safe_div(coef(0) * s_star + c0, q2s)
    ok1 = (q2s > d_floor) & (us > -0.5) & (us < g.w_img - 0.5)
    i_star = _clean_idx(us * g.u_scale, ok1)

    # pass 2: full projection at output cell (k, b, g)
    qf = a_col[..., None, None, None] * gc + cc[..., None]  # (..., 3, nz, n_b, n_g)
    d_star = qf[..., 2, :, :, :]
    vs = _safe_div(qf[..., 1, :, :, :], d_star)
    ok2 = (d_star > d_floor) & (vs > -0.5) & (vs < g.h_img - 0.5)
    j_star = _clean_idx(vs * g.v_scale, ok2)
    kd_star = _clean_idx((d_star - g.d0) / g.dd, ok2)
    return i_star, j_star, kd_star


class SampleFields(NamedTuple):
    """Index fields of a batch in the fields-in kernel's layout."""
    i_star: torch.Tensor    # (B, N, fH, nz, max(nx, ny)) int32
    j_star: torch.Tensor    # (B, N, nz, ny * nx) int32
    kd_star: torch.Tensor   # (B, N, nz, ny * nx) int32


def pack_fields(per_camera, g: _Geom) -> SampleFields:
    """Pack per-camera JAX-layout fields ``[(i, j, kd), ...]`` (each with
    the batch dim in front) into the kernel's layout."""
    i0 = per_camera[0][0]
    b, n_cams = i0.shape[0], len(per_camera)
    i_all = torch.full((b, n_cams, g.f_h, g.nz, max(g.nx, g.ny)), -1,
                       dtype=torch.int32, device=i0.device)
    for n, (i, _, _) in enumerate(per_camera):
        i_all[:, n, ..., :i.shape[-1]] = i
    j_all = torch.stack([j.flatten(-2) for _, j, _ in per_camera], 1)
    kd_all = torch.stack([kd.flatten(-2) for _, _, kd in per_camera], 1)
    return SampleFields(i_all, j_all.contiguous(), kd_all.contiguous())


def geometry_fields(minv, mt, g: _Geom, solve_x: Sequence[bool]) -> SampleFields:
    """Index fields of a batch: minv (B, N, 3, 3), mt (B, N, 3) f32."""
    per_camera = [None] * len(solve_x)
    for sx in (True, False):
        cams = [n for n, s in enumerate(solve_x) if bool(s) == sx]
        if not cams:
            continue
        i, j, kd = _sample_indices(minv[:, cams], mt[:, cams], sx, g)
        for k, n in enumerate(cams):
            per_camera[n] = (i[:, k], j[:, k], kd[:, k])
    return pack_fields(per_camera, g)


def _camera_cells(i_star, j_star, kd_star, solve_x, ny, nx, d_bins):
    """Per camera n, over the (B, ny, nx, nz) output cells: the cell's
    row and depth bin, the column read at that row (-1 where row or bin is
    out of range: the word is not read), the word's flat index in
    ``i_star[b, n]`` (row clamped) and whether it is read."""
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
        word = (j.clamp(0, f_h - 1) * nz + z) * nb + col
        i = torch.where(read_i, i_star[:, n].flatten(1)[bb, word], -1)
        yield n, j, i, kd, word, read_i


def cell_indices(i_star, j_star, kd_star, solve_x: Sequence[bool], ny: int,
                 nx: int, d_bins: int):
    """(j, i, kd), each (B, ny, nx, nz, N) int32: what every cell uses per
    camera (the layout of the kernel's index dump)."""
    cams = list(_camera_cells(i_star, j_star, kd_star, solve_x, ny, nx,
                              d_bins))
    return tuple(torch.stack([c[k] for c in cams], -1) for k in (1, 2, 3))


def gather_cells(feat, depth, j, i, kd, out_dtype: torch.dtype):
    """Plain gather-multiply-sum on per-cell indices (B, ny, nx, nz, N):
    in f32, with the cameras summed in order; a camera adds nothing where
    j, i or kd is out of range."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    acc = torch.zeros(j.shape[:4] + (c_ch,), dtype=torch.float32,
                      device=feat.device)
    for n in range(n_cams):
        jn, i_n, kn = j[..., n], i[..., n], kd[..., n]
        ok = ((jn >= 0) & (jn < f_h) & (i_n >= 0) & (i_n < f_w) & (kn >= 0)
              & (kn < d_bins))
        jc, ic = jn.clamp(0, f_h - 1), i_n.clamp(0, f_w - 1)
        w = depth[bb, n, jc, ic, kn.clamp(0, d_bins - 1)].float() * ok
        acc += feat[bb, n, jc, ic].float() * w[..., None]
    return acc.to(out_dtype)


def scatter_cells(grad, feat, depth, j, i, kd):
    """Plain backward of :func:`gather_cells` on the same indices:
    ``index_add_`` of ``grad`` (B, ny, nx, nz, C) into d feat (the cell's
    gradient row times the depth value it read) and d depth (the cell's
    gradient row dotted with the feature row it read), in f32, returned
    in the dtypes of feat and depth."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    g = grad.float().reshape(-1, c_ch)
    feat_rows = feat.reshape(-1, c_ch)
    depth_flat = depth.reshape(-1)
    dfeat = torch.zeros((feat_rows.shape[0], c_ch), dtype=torch.float32,
                        device=feat.device)
    ddepth = torch.zeros(depth_flat.shape, dtype=torch.float32,
                         device=feat.device)
    for n in range(n_cams):
        jn, i_n, kn = j[..., n], i[..., n], kd[..., n]
        ok = ((jn >= 0) & (jn < f_h) & (i_n >= 0) & (i_n < f_w) & (kn >= 0)
              & (kn < d_bins)).reshape(-1)
        pix = (((bb * n_cams + n) * f_h + jn.clamp(0, f_h - 1)) * f_w
               + i_n.clamp(0, f_w - 1)).reshape(-1)
        at = pix * d_bins + kn.clamp(0, d_bins - 1).reshape(-1)
        w = depth_flat[at].float() * ok
        dfeat.index_add_(0, pix, g * w[:, None])
        ddepth.index_add_(0, at, (g * feat_rows[pix].float()).sum(-1) * ok)
    return (dfeat.view(feat.shape).to(feat.dtype),
            ddepth.view(depth.shape).to(depth.dtype))


# ---- fields in -----------------------------------------------------------------

def lss_sample_reference(feat, depth, i_star, j_star, kd_star,
                         solve_x: Sequence[bool], ny: int, nx: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`lss_sample`."""
    return gather_cells(feat, depth, *cell_indices(
        i_star, j_star, kd_star, solve_x, ny, nx, depth.shape[-1]), out_dtype)


def lss_sample_bytes(feat, depth, i_star, j_star, kd_star,
                     solve_x: Sequence[bool], ny: int, nx: int,
                     out_dtype: torch.dtype, fields_read: bool = True) -> int:
    """Bytes that the function must move on these inputs, each needed
    element once: each depth value and feature row that a contributing
    cell gathers and the output written once; with ``fields_read`` (the
    fields-in entry) also all of ``j_star`` and ``kd_star`` (every cell
    reads its row and depth bin for every camera) and each ``i_star`` word
    that a cell with its row and bin in range reads."""
    b, n_cams, f_h, f_w, c_ch = feat.shape
    d_bins = depth.shape[-1]
    bb = torch.arange(b, device=feat.device).view(b, 1, 1, 1)
    words_per_image = f_h * i_star.shape[3] * i_star.shape[4]

    def distinct(index, mask):
        return int(torch.unique(index.long()[mask]).numel())

    nbytes = b * ny * nx * j_star.shape[2] * c_ch * out_dtype.itemsize
    if fields_read:
        nbytes += 4 * (j_star.numel() + kd_star.numel())
    for _, j, i, kd, word, read_i in _camera_cells(
            i_star, j_star, kd_star, solve_x, ny, nx, d_bins):
        ok = read_i & (i >= 0) & (i < f_w)
        pix = (bb * f_h + j.long()) * f_w + i
        if fields_read:
            nbytes += 4 * distinct(bb * words_per_image + word, read_i)
        nbytes += feat.element_size() * c_ch * distinct(pix, ok)
        nbytes += depth.element_size() * distinct(pix * d_bins + kd, ok)
    return nbytes


def _check_inputs(feat, depth, solve_x):
    if feat.dim() != 5 or depth.dim() != 5:
        raise ValueError(f'feat/depth must be (B, N, fH, fW, C/D), got '
                         f'{tuple(feat.shape)} / {tuple(depth.shape)}')
    b, n_cams, f_h, f_w, _ = feat.shape
    if tuple(depth.shape[:4]) != (b, n_cams, f_h, f_w):
        raise ValueError(f'depth {tuple(depth.shape)} does not match feat '
                         f'{tuple(feat.shape)}')
    if len(solve_x) != n_cams:
        raise ValueError(f'{len(solve_x)} solve_x flags for {n_cams} cameras')


def _check_shapes(feat, depth, i_star, j_star, kd_star, solve_x, ny, nx):
    _check_inputs(feat, depth, solve_x)
    b, n_cams, f_h = feat.shape[:3]
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


def _check_card(name, feat, depth, out_dtype, tensors, nz):
    """What the kernel takes on the card, beyond the shapes."""
    if any(t.device != feat.device for t in tensors):
        raise ValueError(f'{name} inputs must share one device')
    if (feat.dtype, out_dtype) not in _SUPPORTED or depth.dtype != feat.dtype:
        raise TypeError(f'{name} kernel takes {sorted(map(str, _SUPPORTED))}'
                        f' (in, out) dtypes, got feat {feat.dtype}, depth '
                        f'{depth.dtype}, out {out_dtype}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} inputs must be contiguous')
    b, n_cams, f_h, f_w, c_ch = feat.shape
    if c_ch % 2 or c_ch > _MAX_CHANNELS or n_cams > _MAX_CAMERAS \
            or nz > _MAX_NZ:
        raise ValueError(f'{name} kernel needs an even C <= {_MAX_CHANNELS}, '
                         f'<= {_MAX_CAMERAS} cameras and nz <= {_MAX_NZ}, got '
                         f'C={c_ch}, N={n_cams}, nz={nz}')
    if b * n_cams * f_h * f_w >= 2 ** 31:
        raise ValueError(f'{name} kernel indexes pixels in int32')
    if feat.data_ptr() % (2 * feat.element_size()):
        raise ValueError('feat must be aligned to two channels for vector '
                         'loads')


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: error {err}')


def lss_sample(feat: torch.Tensor, depth: torch.Tensor, i_star: torch.Tensor,
               j_star: torch.Tensor, kd_star: torch.Tensor,
               solve_x: Sequence[bool], ny: int, nx: int,
               out_dtype: torch.dtype = None) -> torch.Tensor:
    """Sample depth-weighted camera features into the BEV grid on
    precomputed index fields.

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

    nz = j_star.shape[2]
    _check_card('lss_sample', feat, depth, out_dtype,
                (feat, depth, i_star, j_star, kd_star), nz)
    if any(t.dtype != torch.int32 for t in (i_star, j_star, kd_star)):
        raise TypeError('lss_sample index fields must be int32')
    b, n_cams, f_h, f_w, c_ch = feat.shape
    out = torch.empty((b, ny, nx, nz, c_ch), dtype=out_dtype,
                      device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        _launch('lss_sample', _kernel('lss_sample_forward'),
                feat.data_ptr(), depth.data_ptr(), i_star.data_ptr(),
                j_star.data_ptr(), kd_star.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[feat.dtype], _DTYPE_CODES[out_dtype],
                _mask(solve_x), b, n_cams, f_h, f_w, c_ch, depth.shape[-1],
                nz, ny, nx, i_star.shape[4], stream)
    lss_sample.launches += 1
    return out


lss_sample.launches = 0


# ---- geometry in: the main path -----------------------------------------------

def lss_sample_bev_reference(feat, depth, minv, mt, geom: _Geom,
                             solve_x: Sequence[bool],
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`lss_sample_bev`: the index fields, then
    the plain gather."""
    return lss_sample_reference(
        feat, depth, *geometry_fields(minv, mt, geom, solve_x), solve_x,
        geom.ny, geom.nx, out_dtype)


def lss_sample_bev_bytes(feat, depth, minv, mt, geom: _Geom,
                         solve_x: Sequence[bool],
                         out_dtype: torch.dtype) -> int:
    """Bytes that the fused function must move on these inputs: each
    gathered depth value and feature row once and the output once
    (:func:`lss_sample_bytes` without index fields), plus the geometry
    (``minv``, ``mt`` and the f32 coordinate tables)."""
    fields = geometry_fields(minv, mt, geom, solve_x)
    tables = geom.f_h + geom.nx + geom.ny + geom.nz
    return (lss_sample_bytes(feat, depth, *fields, solve_x, geom.ny, geom.nx,
                             out_dtype, fields_read=False)
            + 4 * (minv.numel() + mt.numel() + tables))


def _check_geometry(feat, depth, minv, mt, geom, solve_x):
    _check_inputs(feat, depth, solve_x)
    b, n_cams, f_h, f_w, _ = feat.shape
    if tuple(minv.shape) != (b, n_cams, 3, 3) \
            or tuple(mt.shape) != (b, n_cams, 3):
        raise ValueError(f'geometry must be minv (B, N, 3, 3) and mt (B, N, '
                         f'3) = ({b}, {n_cams}, ...), got '
                         f'{tuple(minv.shape)} / {tuple(mt.shape)}')
    if minv.dtype != torch.float32 or mt.dtype != torch.float32:
        raise TypeError(f'geometry must be float32, got {minv.dtype} / '
                        f'{mt.dtype}')
    if depth.dtype != feat.dtype:
        raise TypeError(f'depth {depth.dtype} and feat {feat.dtype} differ')
    if (geom.f_h, geom.f_w) != (f_h, f_w):
        raise ValueError(f'geom is for {geom.f_h}x{geom.f_w} features, feat '
                         f'has {f_h}x{f_w}')


def _geom_consts(g: _Geom):
    """The index math's Python-float constants as the f32 values that
    PyTorch's CUDA ops use: a scalar operand is cast to f32, and a
    division by a scalar multiplies by its f32 reciprocal."""
    f32 = np.float32
    return (f32(max(1e-3, g.d0 * 0.5)), f32(g.d0), f32(1) / f32(g.dd),
            f32(g.u_scale), f32(g.v_scale), f32(g.w_img - 0.5),
            f32(g.h_img - 0.5))


@functools.lru_cache(maxsize=8)
def _device_tables(args, device):
    """ys | xc | yc | zc of ``_Geom(*args)`` as one f32 tensor on
    ``device``, uploaded once."""
    g = _Geom(*args)
    return torch.from_numpy(np.concatenate([g.ys, g.xc, g.yc, g.zc])).to(
        device)


def lss_sample_bev(feat: torch.Tensor, depth: torch.Tensor,
                   minv: torch.Tensor, mt: torch.Tensor, geom: _Geom,
                   solve_x: Sequence[bool], out_dtype: torch.dtype = None,
                   dump: bool = False):
    """Sample depth-weighted camera features into the BEV grid from the
    camera geometry, computing the index fields on the way.

    A CPU tensor goes to :func:`lss_sample_bev_reference`; a CUDA tensor
    launches the fused kernel (dtypes as :func:`lss_sample`) or raises.
    Returns (B, ny, nx, nz, C) in ``out_dtype`` (default ``feat.dtype``);
    with ``dump``, also the (j, i, kd) used, as :func:`cell_indices` gives
    them (on the card written by the kernel's dumping instance, for
    checking only).
    """
    solve_x = tuple(bool(s) for s in solve_x)
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    _check_geometry(feat, depth, minv, mt, geom, solve_x)
    if feat.device.type == 'cpu':
        if not dump:
            return lss_sample_bev_reference(feat, depth, minv, mt, geom,
                                            solve_x, out_dtype)
        idx = cell_indices(*geometry_fields(minv, mt, geom, solve_x),
                           solve_x, geom.ny, geom.nx, depth.shape[-1])
        return gather_cells(feat, depth, *idx, out_dtype), idx
    if feat.device.type != 'cuda':
        raise ValueError(f'no lss_sample_bev for device {feat.device}')

    _check_card('lss_sample_bev', feat, depth, out_dtype,
                (feat, depth, minv, mt), geom.nz)
    b, n_cams, f_h, f_w, c_ch = feat.shape
    ny, nx, nz = geom.ny, geom.nx, geom.nz
    dev = feat.device
    out = torch.empty((b, ny, nx, nz, c_ch), dtype=out_dtype, device=dev)
    idx = tuple(torch.empty((b, ny, nx, nz, n_cams), dtype=torch.int32,
                            device=dev) for _ in range(3)) if dump else None
    tables = _device_tables(geom.args, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch('lss_sample_bev', _kernel('lss_sample_bev_forward'),
                feat.data_ptr(), depth.data_ptr(), minv.data_ptr(),
                mt.data_ptr(), tables.data_ptr(), out.data_ptr(),
                *([t.data_ptr() for t in idx] if dump else [None] * 3),
                _DTYPE_CODES[feat.dtype], _DTYPE_CODES[out_dtype],
                _mask(solve_x), b, n_cams, f_h, f_w, c_ch, depth.shape[-1],
                nz, ny, nx, *(float(v) for v in _geom_consts(geom)), stream)
    lss_sample_bev.launches += 1
    return (out, idx) if dump else out


lss_sample_bev.launches = 0


def lss_sample_bev_backward_reference(grad, feat, depth, minv, mt,
                                      geom: _Geom, solve_x: Sequence[bool]):
    """Plain version of :func:`lss_sample_bev_backward`: the index
    fields, then :func:`scatter_cells`."""
    idx = cell_indices(*geometry_fields(minv, mt, geom, solve_x), solve_x,
                       geom.ny, geom.nx, depth.shape[-1])
    return scatter_cells(grad, feat, depth, *idx)


def lss_sample_bev_backward_cost(grad, feat, depth, minv, mt, geom: _Geom,
                                 solve_x: Sequence[bool]):
    """(f32 operations, bytes) that the backward needs on these inputs:
    4 C operations (2 per channel into d feat, 2 into d depth) for each
    (cell, camera) whose indices are in range; the gradient and each
    gathered depth value and feature row read once (the forward's count,
    :func:`lss_sample_bev_bytes`, with the gradient in place of the
    output), and d feat and d depth written once."""
    idx = cell_indices(*geometry_fields(minv, mt, geom, solve_x), solve_x,
                       geom.ny, geom.nx, depth.shape[-1])
    f_h, f_w, d_bins = feat.shape[2], feat.shape[3], depth.shape[-1]
    j, i, kd = idx
    pairs = int(((j >= 0) & (j < f_h) & (i >= 0) & (i < f_w) & (kd >= 0)
                 & (kd < d_bins)).sum())
    nbytes = (lss_sample_bev_bytes(feat, depth, minv, mt, geom, solve_x,
                                   grad.dtype)
              + feat.numel() * feat.element_size()
              + depth.numel() * depth.element_size())
    return 4 * feat.shape[-1] * pairs, nbytes


def lss_sample_bev_backward(grad: torch.Tensor, feat: torch.Tensor,
                            depth: torch.Tensor, minv: torch.Tensor,
                            mt: torch.Tensor, geom: _Geom,
                            solve_x: Sequence[bool]):
    """Gradients of :func:`lss_sample_bev` for feat and depth, given the
    output's gradient ``grad`` (B, ny, nx, nz, C) in feat's dtype.

    A CPU tensor goes to :func:`lss_sample_bev_backward_reference`; a
    CUDA tensor launches the pixel-major backward kernels or raises: the
    pairs are bucketed by pixel (count, ``torch.cumsum``, fill) and each
    pixel sums its bucket in increasing cell order, as the plain
    ``index_add_`` does on the CPU, into outputs in feat's and depth's
    dtype, every element written once.  Two runs give identical bits.
    """
    solve_x = tuple(bool(s) for s in solve_x)
    _check_geometry(feat, depth, minv, mt, geom, solve_x)
    b, n_cams, f_h, f_w, c_ch = feat.shape
    ny, nx, nz = geom.ny, geom.nx, geom.nz
    d_bins = depth.shape[-1]
    if tuple(grad.shape) != (b, ny, nx, nz, c_ch):
        raise ValueError(f'grad must be (B, ny, nx, nz, C) = '
                         f'{(b, ny, nx, nz, c_ch)}, got {tuple(grad.shape)}')
    if grad.dtype != feat.dtype:
        raise TypeError(f'grad must have feat\'s dtype {feat.dtype}, got '
                        f'{grad.dtype}')
    if feat.device.type == 'cpu':
        return lss_sample_bev_backward_reference(grad, feat, depth, minv, mt,
                                                 geom, solve_x)
    if feat.device.type != 'cuda':
        raise ValueError(f'no lss_sample_bev_backward for device '
                         f'{feat.device}')

    _check_card('lss_sample_bev_backward', feat, depth, feat.dtype,
                (feat, depth, minv, mt, grad), nz)
    cells = ny * nx * nz
    if cells * d_bins >= 2 ** 31 or b * cells * n_cams >= 2 ** 31:
        raise ValueError('lss_sample_bev_backward keys its pairs (cell * D + '
                         'kd, and one slot per cell and camera) in int32')
    dev = feat.device
    counts, ends, keys, ordered = _backward_scratch(feat.shape, geom, dev)
    dfeat = torch.empty(feat.shape, dtype=feat.dtype, device=dev)
    ddepth = torch.empty(depth.shape, dtype=depth.dtype, device=dev)
    tables = _device_tables(geom.args, dev)
    shape = (_mask(solve_x), b, n_cams, f_h, f_w, c_ch, d_bins, nz, ny, nx,
             *(float(v) for v in _geom_consts(geom)))
    name = 'lss_sample_bev_backward'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(name, _kernel('lss_sample_bev_backward_count'),
                minv.data_ptr(), mt.data_ptr(), tables.data_ptr(),
                counts.data_ptr(), *shape, stream)
        torch.cumsum(counts, 0, dtype=torch.int32, out=ends)
        _launch(name, _kernel(name), grad.data_ptr(), feat.data_ptr(),
                depth.data_ptr(), minv.data_ptr(), mt.data_ptr(),
                tables.data_ptr(), counts.data_ptr(), ends.data_ptr(),
                keys.data_ptr(), ordered.data_ptr(), dfeat.data_ptr(),
                ddepth.data_ptr(), _DTYPE_CODES[feat.dtype], *shape, stream)
    lss_sample_bev_backward.launches += 1
    return dfeat, ddepth


lss_sample_bev_backward.launches = 0


def _backward_scratch(feat_shape, geom: _Geom, device):
    """int32 scratch of the backward, views of one buffer: the pixels'
    counts and bucket ends (B N fH fW each) and two key lists (the fill's
    and a sorted copy) with room for every (cell, camera) pair."""
    b, n_cams, f_h, f_w, _ = feat_shape
    n_pix = b * n_cams * f_h * f_w
    cap = b * geom.ny * geom.nx * geom.nz * n_cams
    sizes = (n_pix, n_pix, cap, cap)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    return buf.split(sizes)


class LSSSampleBEV(torch.autograd.Function):
    """:func:`lss_sample_bev` with :func:`lss_sample_bev_backward` as its
    gradient for feat and depth (none for the geometry).

    ``LSSSampleBEV.apply(feat, depth, minv, mt, geom, solve_x)``, the
    output in feat's dtype; one forward launch per call, one backward
    launch per backward pass.
    """

    @staticmethod
    def forward(ctx, feat, depth, minv, mt, geom, solve_x):
        ctx.save_for_backward(feat, depth, minv, mt)
        ctx.geom, ctx.solve_x = geom, tuple(bool(s) for s in solve_x)
        return lss_sample_bev(feat, depth, minv, mt, geom, solve_x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        feat, depth, minv, mt = ctx.saved_tensors
        dfeat, ddepth = lss_sample_bev_backward(
            grad.contiguous(), feat, depth, minv, mt, ctx.geom, ctx.solve_x)
        return dfeat, ddepth, None, None, None, None


def _mask(solve_x):
    return sum(1 << n for n, sx in enumerate(solve_x) if sx)


# C signatures of the entry points of ``csrc/lss_sample.cu``: pointers,
# then ints / the solve_x mask / float constants, then the stream.
_PTR, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
_GEOM = [_U32] + [_I32] * 9 + [_F32] * 7 + [_PTR]
_ARGTYPES = {
    'lss_sample_forward': [_PTR] * 6 + [_I32, _I32, _U32] + [_I32] * 10
                          + [_PTR],
    'lss_sample_bev_forward': [_PTR] * 9 + [_I32, _I32] + _GEOM,
    'lss_sample_bev_backward_count': [_PTR] * 4 + _GEOM,
    'lss_sample_bev_backward': [_PTR] * 12 + [_I32] + _GEOM,
    'lss_sample_bev_backward_atomic': [_PTR] * 8 + [_I32] + _GEOM,
}


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """Entry point ``entry`` of ``csrc/lss_sample.cu``, with its C
    signature."""
    from omnihd_scenes_tpu_torch.kernels._build import load_library

    fn = getattr(load_library('lss_sample'), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn
