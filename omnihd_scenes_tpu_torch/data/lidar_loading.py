"""LiDAR point loading (single frame + optional multisweep).

Parity targets: mmdet3d ``LoadPointsFromFile`` as configured by
``configs/PointPillars_NewScenes/pointpillars_LiDAR.py:122-126``
(``load_dim=6, use_dim=4``) and the devkit's multisweep aggregation
(``newscenes_devkit/data_classes.py:from_file_multisweep``): sweeps are
chained through sensor2lidar transforms with a per-point time-lag
channel.  Host-side NumPy.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.data.radar_loading import pad_or_drop


def load_lidar_points(lidar_path: str, load_dim: int = 5,
                      use_dim: int = 4) -> np.ndarray:
    """Read a float32 ``.bin`` as (N, use_dim)."""
    pts = np.fromfile(lidar_path, dtype=np.float32)
    n = (pts.shape[0] // load_dim) * load_dim
    return pts[:n].reshape(-1, load_dim)[:, :use_dim].copy()


def load_lidar_multisweep(info: Dict,
                          load_dim: int = 5,
                          use_dim: int = 4,
                          max_sweeps: int = 10,
                          max_num: int = 120000,
                          pc_range: Sequence[float] = None,
                          rng: np.random.RandomState = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Keyframe + sweeps -> padded (max_num, use_dim + 1) with time lag."""
    key_ts = info['timestamp'] * 1e-6
    clouds = []

    key_pts = load_lidar_points(info['lidar_path'], load_dim, use_dim)
    clouds.append(np.concatenate(
        [key_pts, np.zeros((key_pts.shape[0], 1), np.float32)], axis=1))

    for sweep in info.get('sweeps', [])[:max_sweeps]:
        pts = load_lidar_points(sweep['data_path'], load_dim, use_dim)
        pts[:, :3] = pts[:, :3] @ np.asarray(
            sweep['sensor2lidar_rotation'], dtype=np.float32).T
        pts[:, :3] += np.asarray(sweep['sensor2lidar_translation'],
                                 dtype=np.float32)
        lag = key_ts - int(sweep['timestamp']) * 1e-6
        clouds.append(np.concatenate(
            [pts, np.full((pts.shape[0], 1), lag, np.float32)], axis=1))

    points = np.concatenate(clouds, axis=0)
    if pc_range is not None:
        keep = ((points[:, 0] > pc_range[0]) & (points[:, 0] < pc_range[3])
                & (points[:, 1] > pc_range[1]) & (points[:, 1] < pc_range[4])
                & (points[:, 2] > pc_range[2]) & (points[:, 2] < pc_range[5]))
        points = points[keep]
    return pad_or_drop(points, max_num, rng)
