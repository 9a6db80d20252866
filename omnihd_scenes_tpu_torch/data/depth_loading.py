"""Depth ground-truth loading + Gaussian depth targets (host-side).

Parity targets:
- ``LoadGTDepth`` (reference ``pipelines/loading.py:17-62``): per-cam
  sparse ``[u, v, d]`` float32 bins (written by
  ``gen_depth_gt_newscenes.py``) rasterized to a depth map at the
  pipeline scale, front/back coordinates pre-scaled by 0.5, padded to
  the model input height.
- ``generate_guassian_depth_target`` (reference ``utils/gaussian.py:
  90-130``): min-pool the depth map by the feature stride, estimate a
  per-patch std, and emit a per-pixel Gaussian distribution over the
  D depth bins (CDF differences).  The reference runs this on GPU in
  the loss; here it is precomputed on host so the device loss is one
  masked KL divergence.

Restated from ``omnihd_scenes_tpu/data/depth_loading.py`` (host NumPy and
SciPy) so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def rasterize_depth(points_uvd: np.ndarray, hw: Tuple[int, int],
                    scale: float = 1.0) -> np.ndarray:
    """Sparse [u, v, d] -> dense (H, W) map (last write wins)."""
    depth = np.zeros(hw, np.float32)
    if len(points_uvd) == 0:
        return depth
    uv = (points_uvd[:, :2] * scale).astype(np.int32)
    ok = ((uv[:, 0] >= 0) & (uv[:, 0] < hw[1])
          & (uv[:, 1] >= 0) & (uv[:, 1] < hw[0]))
    depth[uv[ok, 1], uv[ok, 0]] = points_uvd[ok, 2]
    return depth


def depth_gt_path(cam_path: str) -> str:
    """Where the ``depth_gt`` bins of one camera image live (and
    ``tools/gen_depth_gt.py`` writes them)."""
    return cam_path.replace('cameras', 'depth_gt') + '.bin'


def load_gt_depth(cam_path: str, hw: Tuple[int, int], scale: float,
                  front_back_scale: float = 0.5,
                  is_front_back: bool = False) -> np.ndarray:
    """Read ``depth_gt`` bins for one camera image path."""
    pts = np.fromfile(depth_gt_path(cam_path),
                      dtype=np.float32).reshape(-1, 3)
    if is_front_back and front_back_scale != 1.0:
        pts = pts.copy()
        pts[:, :2] *= front_back_scale
    return rasterize_depth(pts, hw, scale)


def gaussian_depth_target(depth: np.ndarray, stride: int,
                          cam_depth_range: Sequence[float],
                          constant_std: float = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Depth map (H, W) -> per-patch Gaussian distribution over D bins.

    Returns (H/stride, W/stride, D) distribution + (H/stride, W/stride)
    min depth (0 where the patch has no observations).
    """
    from scipy.stats import norm

    h, w = depth.shape
    hh, ww = h // stride, w // stride
    patches = depth[:hh * stride, :ww * stride].reshape(
        hh, stride, ww, stride).transpose(0, 2, 1, 3).reshape(hh, ww, -1)

    valid = patches != 0
    n_valid = valid.sum(-1).astype(np.float64)
    n_safe = np.where(n_valid == 0, 1e10, n_valid)

    mean = patches.sum(-1) / n_safe
    var = (((patches - mean[..., None]) ** 2) * valid).sum(-1) / n_safe
    std = np.sqrt(var)
    std[n_valid == 1] = 1.0
    if constant_std is not None:
        std = np.full_like(std, constant_std)

    masked = np.where(valid, patches, 1e10)
    min_depth = masked.min(-1)
    min_depth[min_depth == 1e10] = 0.0

    d0, d1, dd = cam_depth_range
    edges = np.arange(d0 - dd / 2, d1, dd)
    # Reference quirk kept: the Normal is parameterized in bin units
    # (min/dd, std/dd) but evaluated at raw-depth edges — identical to
    # the natural formula for the dd=1 configs OmniHD uses.
    loc = (min_depth / dd)[..., None]
    scale = np.maximum(std / dd, 1e-6)[..., None]
    cdf = norm.cdf((edges - loc) / scale)
    dist = (cdf[..., 1:] - cdf[..., :-1]).astype(np.float32)
    return dist, min_depth.astype(np.float32)
