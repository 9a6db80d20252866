"""128-beam LiDAR beam-reduction (sensor-ablation studies; counterpart of
``omnihd_scenes_tpu/data/beam_reduction.py``, NumPy as there).

Parity target: ``reduce_LiDAR_beams``
(reference ``datasets/pipelines/loading.py:521-577``): points are moved
into the (hardcoded-calibration) lidar frame, bucketed by elevation
against the 128-beam angle table, and only every k-th beam's bucket is
kept (64/32/16/4-beam subsets), then moved back to the ego frame.
"""

from __future__ import annotations

import numpy as np

from omnihd_scenes_tpu_torch.devkit.geometry import transform_points

# 128-beam elevation table (degrees), reference ``loading.py:522``.
BEAM_RANGE_DEG = [
    -25, -19.582, -16.042, -13.565, -11.742, -10.346, -9.244, -8.352,
    -7.65, -7.15, -6.85, -6.65, -6.5, -6.39, -6.29, -6.19, -6.09, -5.99,
    -5.89, -5.79, -5.69, -5.59, -5.49, -5.39, -5.29, -5.19, -5.09, -4.99,
    -4.89, -4.79, -4.69, -4.59, -4.49, -4.39, -4.29, -4.19, -4.09, -3.99,
    -3.89, -3.79, -3.69, -3.59, -3.49, -3.39, -3.29, -3.19, -3.09, -2.99,
    -2.89, -2.79, -2.69, -2.59, -2.49, -2.39, -2.29, -2.19, -2.09, -1.99,
    -1.89, -1.79, -1.69, -1.59, -1.49, -1.39, -1.29, -1.19, -1.09, -0.99,
    -0.89, -0.79, -0.69, -0.59, -0.49, -0.39, -0.29, -0.19, -0.09, 0.01,
    0.11, 0.21, 0.31, 0.41, 0.51, 0.61, 0.71, 0.81, 0.91, 1.01, 1.11,
    1.21, 1.31, 1.41, 1.51, 1.61, 1.71, 1.81, 1.91, 2.01, 2.11, 2.21,
    2.31, 2.41, 2.51, 2.61, 2.71, 2.81, 2.91, 3.01, 3.11, 3.21, 3.31,
    3.41, 3.51, 3.61, 3.71, 3.81, 3.96, 4.16, 4.41, 4.71, 5.06, 5.46,
    5.96, 6.56, 7.41, 9, 11.5, 15]

# Reference hardcoded lidar<->ego calibration (``loading.py:526``).
LIDAR2EGO = np.array([
    [0.999648, 0.019996, -0.017452, 1.26],
    [-0.019999, 0.9998, 0, 0],
    [0.017449, 0.000349, 0.999848, 1.855],
    [0, 0, 0, 1]])

_BEAM_IDS = {
    64: list(range(1, 128, 2)),
    32: list(range(3, 128, 4)),
    16: list(range(7, 128, 8)),
    4: [31, 63, 95, 127],
}
_EPS = 0.000873


def reduce_lidar_beams(points: np.ndarray,
                       reduce_beams_to: int = 32) -> np.ndarray:
    """Keep only the selected beams of a 128-beam cloud (N, >=3)."""
    beam_range = np.sort(np.radians(BEAM_RANGE_DEG))[::-1]
    ego2lidar = np.linalg.inv(LIDAR2EGO)

    xyz = transform_points(points[:, :3].astype(np.float64), ego2lidar)
    radius = np.linalg.norm(xyz, axis=1)
    radius = np.where(radius < 1e-9, 1e-9, radius)
    theta = np.arcsin(np.clip(xyz[:, 2] / radius, -1.0, 1.0))

    ids = _BEAM_IDS.get(reduce_beams_to, list(range(30, 90)))
    mask = np.zeros(len(points), bool)
    for bid in ids:
        mask |= ((theta < beam_range[bid - 1] - _EPS)
                 & (theta > beam_range[bid] - _EPS))

    kept = points[mask].copy()
    kept[:, :3] = transform_points(
        transform_points(kept[:, :3].astype(np.float64), ego2lidar),
        LIDAR2EGO)
    return kept
