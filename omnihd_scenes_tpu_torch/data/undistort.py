"""OpenCV's plumb-bob undistortion map without OpenCV.

The counterpart of ``cv2.initUndistortRectifyMap(K, (k1, k2, p1, p2, k3),
None, K, (w, h), cv2.CV_16SC2)``, which the JAX package's camera loader
calls once per scene and camera (``omnihd_scenes_tpu/data/
image_loading.py:58-61``) and feeds to ``cv2.remap``.  Restated here from
OpenCV's scalar loop (``undistort.dispatch.cpp``,
``initUndistortRectifyMapComputer``) in f64 NumPy, so that the card's
decode path (``kernels/rectify.py``) needs no OpenCV:

* ``ir`` is the inverse of the new camera matrix by OpenCV's 3x3 rule
  (cofactors times the reciprocal of the determinant), not ``np.linalg.
  inv``: the rounding of ``ir`` moves map entries that sit on a 1/32-px
  boundary;
* each row starts at ``i * ir[1] + ir[2]`` and adds ``ir[0]`` per column
  (the loop's running sum, not ``j * ir[0]``);
* the distorted point ``u = fx * xd + u0`` (likewise ``v``) is stored in
  OpenCV's ``CV_16SC2`` fixed point: ``cvRound(u * 32)``, i.e. an integer
  source pixel plus a 5-bit fraction on each axis.

OpenCV may run a vectorised copy of the loop that fuses multiply-adds, so
a few map entries that sit within an f64 rounding of a 1/64-px boundary
can differ from it by one 1/32-px step (the tests bound their share).
Zero distortion means no remap, as in the JAX loader (``:53``).

:func:`fused_rectify_map` is the JAX fast decode's map
(``image_loading.py:66-98``, ``_fused_rectify_map``): built at the
output size with the new camera matrix ``K`` scaled by the net scale,
stored as ``CV_32FC1`` (each coordinate rounded to f32), divided by the
reduced decode's factor (exact at 2, 4, 8), then ``cv2.convertMaps`` to
``CV_16SC2``: ``cvRound(x * 32)`` of the f32 value, half to even.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS            # 1/32-px steps

_MAP_CACHE: Dict[tuple, np.ndarray] = {}


def _inv3(a: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a 3x3 f64 matrix (``cv::invert`` for n = 3):
    the cofactors times one reciprocal of the determinant, each product
    rounded as the C++ expression rounds it."""
    a = [[float(v) for v in row] for row in np.asarray(a, np.float64)]
    d = (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
         - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
         + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    if d == 0.0:
        raise ValueError('singular camera matrix')
    d = 1.0 / d
    return np.array([
        [(a[1][1] * a[2][2] - a[1][2] * a[2][1]) * d,
         (a[0][2] * a[2][1] - a[0][1] * a[2][2]) * d,
         (a[0][1] * a[1][2] - a[0][2] * a[1][1]) * d],
        [(a[1][2] * a[2][0] - a[1][0] * a[2][2]) * d,
         (a[0][0] * a[2][2] - a[0][2] * a[2][0]) * d,
         (a[0][2] * a[1][0] - a[0][0] * a[1][2]) * d],
        [(a[1][0] * a[2][1] - a[1][1] * a[2][0]) * d,
         (a[0][1] * a[2][0] - a[0][0] * a[2][1]) * d,
         (a[0][0] * a[1][1] - a[0][1] * a[1][0]) * d]])


def undistort_map(intrinsic: np.ndarray, distortion,
                  hw: Tuple[int, int],
                  new_intrinsic: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The f64 source coordinates (u, v), each (h, w), of an (h, w) map
    that undistorts an image with camera matrix ``intrinsic`` (3x3) and
    plumb-bob ``distortion`` (k1, k2, p1, p2, k3) onto the new camera
    matrix ``new_intrinsic`` (default ``intrinsic``)."""
    h, w = (int(v) for v in hw)
    k = np.asarray(intrinsic, np.float64)[:3, :3]
    k1, k2, p1, p2, k3 = (float(v) for v in
                          np.asarray(distortion, np.float64).reshape(-1)[:5])
    ir = _inv3(k if new_intrinsic is None else
               np.asarray(new_intrinsic, np.float64)[:3, :3]).reshape(-1)
    fx, fy, u0, v0 = float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), \
        float(k[1, 2])
    rows = np.arange(h, dtype=np.float64)[:, None]

    def running(c_row, c_col, c0):
        """The loop's running sum: row start, then + c_col per column."""
        out = np.empty((h, w), np.float64)
        out[:, :1] = rows * c_row + c0
        out[:, 1:] = c_col
        return np.cumsum(out, axis=1)

    _x = running(ir[1], ir[0], ir[2])
    _y = running(ir[4], ir[3], ir[5])
    _w = running(ir[7], ir[6], ir[8])
    inv_w = 1.0 / _w
    x, y = _x * inv_w, _y * inv_w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2       # k4..k6 = 0: / 1
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + p2 * _2xy
    return fx * xd + u0, fy * yd + v0


def fixed_point_map(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(h, w, 2) int32 source coordinates in 1/32 px, ``cvRound(u * 32)``
    (round half to even, as ``lrint``): the pixel is ``c >> 5``, the
    fraction ``c & 31``."""
    scale = float(INTER_TAB_SIZE)
    lim = float(np.iinfo(np.int32).max)
    return np.stack([np.clip(np.rint(u * scale), -lim - 1, lim),
                     np.clip(np.rint(v * scale), -lim - 1, lim)],
                    -1).astype(np.int32)


def to_cv16sc2(fixed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The ``CV_16SC2`` pair of a :func:`fixed_point_map`: (h, w, 2)
    int16 integer pixels and (h, w) uint16 fraction index
    ``(v & 31) * 32 + (u & 31)``, as ``cv2.initUndistortRectifyMap``
    returns them."""
    iu, iv = fixed[..., 0], fixed[..., 1]
    xy = np.stack([iu >> INTER_BITS, iv >> INTER_BITS], -1).astype(np.int16)
    frac = ((iv & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
            + (iu & (INTER_TAB_SIZE - 1))).astype(np.uint16)
    return xy, frac


def rectify_map(intrinsic: np.ndarray, distortion,
                hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """The cached fixed-point undistortion map of one camera, or None
    when ``distortion`` is all zero (no remap).  Keyed by the camera
    matrix, the coefficients and the size, which is all the map depends
    on (the JAX loader keys it by scene and camera)."""
    dist = np.asarray(distortion, np.float64).reshape(-1)
    if not np.any(dist):
        return None
    k = np.ascontiguousarray(np.asarray(intrinsic, np.float64)[:3, :3])
    key = (k.tobytes(), dist.tobytes(), int(hw[0]), int(hw[1]))
    fixed = _MAP_CACHE.get(key)
    if fixed is None:
        fixed = fixed_point_map(*undistort_map(k, dist, hw))
        _MAP_CACHE[key] = fixed
    return fixed


def fused_size(src_hw: Tuple[int, int], net_scale: float) -> Tuple[int, int]:
    """The output (h, w) of the JAX fast decode of a ``src_hw`` image at
    ``net_scale``: ``(int(h * net), int(w * net))``."""
    return int(src_hw[0] * net_scale), int(src_hw[1] * net_scale)


def fused_rectify_map(intrinsic: np.ndarray, distortion,
                      src_hw: Tuple[int, int], net_scale: float,
                      factor: int) -> Optional[np.ndarray]:
    """The cached fixed-point map (out_h, out_w, 2) int32, in 1/32 px of
    the image decoded at ``1 / factor``, that undistorts and rescales a
    ``src_hw`` camera image to :func:`fused_size` in one remap (JAX's
    ``_fused_rectify_map``), or None when ``distortion`` is all zero."""
    dist = np.asarray(distortion, np.float64).reshape(-1)
    if not np.any(dist):
        return None
    k = np.ascontiguousarray(np.asarray(intrinsic, np.float64)[:3, :3])
    key = (k.tobytes(), dist.tobytes(), int(src_hw[0]), int(src_hw[1]),
           float(net_scale), int(factor), 'fused')
    fixed = _MAP_CACHE.get(key)
    if fixed is None:
        k_new = k.copy()
        k_new[:2] *= net_scale
        u, v = undistort_map(k, dist, fused_size(src_hw, net_scale), k_new)
        u, v = u.astype(np.float32), v.astype(np.float32)
        if factor != 1:
            u, v = u / np.float32(factor), v / np.float32(factor)
        scale = np.float32(INTER_TAB_SIZE)
        fixed = np.stack([np.rint(u * scale), np.rint(v * scale)],
                         -1).astype(np.int32)
        _MAP_CACHE[key] = fixed
    return fixed
