"""4D-radar multi-sweep loading with ego-motion Doppler compensation.

Parity target: ``LoadRadarPointsMultiSweeps``
(reference ``datasets/pipelines/loading.py:116-316``) — THE OmniHD radar
loader.  Raw ``.bin`` files are float32 x8:
``[x, y, z, v_r, power, motion_state, SNR, valid_flag]``.

Per sensor x sweep:
1. decompose the ego velocity into the sensor frame and add its radial
   component to the measured radial velocity (``:246-262``);
2. project the compensated radial speed back to (vx, vy) in the sensor
   frame and rotate into the current lidar frame (``:263-279``);
3. transform point positions into the current lidar frame (``:281-286``);
4. emit 10 dims ``[x, y, z, vx_comp, vy_comp, power, snr, time_diff,
   Vr_comp, radar_ID]`` (``:288-292``).

All six radars' sweeps are concatenated, column-selected by ``use_dim``,
range-cropped, and padded/dropped to a static ``max_num`` buffer (the
reference's own ``_pad_or_drop``, ``loading.py:178-207``).
Host-side NumPy: this runs in the input pipeline, not on device.

Restated from ``omnihd_scenes_tpu/data/radar_loading.py``: a sweep
decodes through the native C++ loader (``data/native.py``, the default, as
in JAX) or, with ``use_native=False``, through NumPy.  Unlike JAX, a
native library that cannot be built or loaded raises instead of falling
back.  The two paths agree within 1e-6 of a row's largest value: the C++
computes in f64 where NumPy's trigonometry runs on f32 arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

RADAR_ID = {'radar_front': 0, 'radar_left_front': 1, 'radar_right_front': 2,
            'radar_back': 3, 'radar_left_back': 4, 'radar_right_back': 5}


def _load_points(path: str) -> np.ndarray:
    if path.endswith('.npy'):
        return np.load(path)
    return np.fromfile(path, dtype=np.float32)


def load_radar_sweep(sweep: Dict, key: str, load_dim: int = 8,
                     ref_ts: float = None,
                     use_native: bool = True) -> np.ndarray:
    """One sensor sweep -> (N, 10) compensated points in the lidar frame
    (native for 8-float rows unless ``use_native=False``)."""
    ts = float(ref_ts if ref_ts is not None
               else int(sweep['timestamp']) * 1e-6)
    if use_native and load_dim == 8:
        from omnihd_scenes_tpu_torch.data import native

        s2e_rot = Quaternion(sweep['sensor2ego_rotation']).rotation_matrix
        return native.radar_sweep_native(
            sweep['data_path'], np.linalg.inv(s2e_rot),
            np.asarray(sweep['sensor2lidar_rotation']),
            np.asarray(sweep['sensor2lidar_translation']),
            np.asarray(sweep['ego_velocity']),
            ts - int(sweep['timestamp']) * 1e-6, RADAR_ID[key])

    pts = _load_points(sweep['data_path']).reshape(-1, load_dim).copy()
    timestamp = int(sweep['timestamp']) * 1e-6
    time_diff = np.full((pts.shape[0], 1), ts - timestamp)

    xyz = pts[:, :3]
    vr = pts[:, 3]
    r = np.linalg.norm(xyz, axis=1)
    r = np.where(r < 1e-6, 1e-6, r)
    azimuth = np.arctan2(xyz[:, 1], xyz[:, 0])
    elevation = np.arcsin(np.clip(xyz[:, 2] / r, -1.0, 1.0))

    # Ego velocity decomposed into the sensor frame.
    v_ego = np.asarray(sweep['ego_velocity'], dtype=np.float64).reshape(1, 3)
    s2e_rot = Quaternion(sweep['sensor2ego_rotation']).rotation_matrix
    v_sensor = (v_ego @ np.linalg.inv(s2e_rot).T)[0]

    vr_comp = (v_sensor[0] * np.cos(azimuth) * np.cos(elevation)
               + v_sensor[1] * np.sin(azimuth) * np.cos(elevation)
               + v_sensor[2] * np.sin(elevation) + vr)
    vx_comp = vr_comp * np.cos(elevation) * np.cos(azimuth)
    vy_comp = vr_comp * np.cos(elevation) * np.sin(azimuth)

    s2l_rot = np.asarray(sweep['sensor2lidar_rotation'], dtype=np.float64)
    velo = np.stack([vx_comp, vy_comp, np.zeros_like(vx_comp)], axis=1)
    velo = (velo @ s2l_rot.T)[:, :2]

    pts[:, :3] = pts[:, :3] @ s2l_rot.T
    pts[:, :3] += np.asarray(sweep['sensor2lidar_translation'])

    radar_id = np.full((pts.shape[0], 1), RADAR_ID[key], dtype=np.float32)
    return np.concatenate(
        [pts[:, :3], velo.astype(np.float32), pts[:, [4, 6]],
         time_diff.astype(np.float32), vr_comp[:, None].astype(np.float32),
         radar_id], axis=1)


def pad_or_drop(points: np.ndarray, max_num: int,
                rng: np.random.RandomState = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Fix the point count to ``max_num``; returns (points, mask)."""
    n = points.shape[0]
    if n > max_num:
        if rng is None:
            rng = np.random
        sel = rng.permutation(n)[:max_num]
        return points[sel].astype(np.float32), np.ones(max_num, bool)
    out = np.zeros((max_num, points.shape[1]), dtype=np.float32)
    out[:n] = points
    mask = np.zeros(max_num, bool)
    mask[:n] = True
    return out, mask


def load_radar_points_multisweep(radars: Dict[str, List[Dict]],
                                 sweeps_num: int = 3,
                                 load_dim: int = 8,
                                 use_dim: Sequence[int] = (0, 1, 2, 3, 4, 5, 6, 7),
                                 max_num: int = 40000,
                                 pc_range: Sequence[float] = (-60, -40, -3.0,
                                                              60, 40, 5.0),
                                 rng: np.random.RandomState = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Info-dict 'radars' -> padded (max_num, len(use_dim)) + mask."""
    sweep_list = []
    for key, sweeps in radars.items():
        idxes = range(min(len(sweeps), sweeps_num))
        ref_ts = int(sweeps[0]['timestamp']) * 1e-6
        for idx in idxes:
            sweep_list.append(load_radar_sweep(sweeps[idx], key, load_dim,
                                               ref_ts=ref_ts))
    points = np.concatenate(sweep_list, axis=0)[:, list(use_dim)]

    in_range = ((points[:, 0] > pc_range[0]) & (points[:, 0] < pc_range[3])
                & (points[:, 1] > pc_range[1]) & (points[:, 1] < pc_range[4])
                & (points[:, 2] > pc_range[2]) & (points[:, 2] < pc_range[5]))
    points = points[in_range]
    return pad_or_drop(points, max_num, rng)
