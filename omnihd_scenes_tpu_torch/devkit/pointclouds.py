"""Point-cloud data classes for the devkit.

Parity target: ``newscenes_devkit/data_classes.py:23-527`` —
``PointCloud`` (d x n array wrapper with transforms and multisweep
aggregation), ``LidarPointCloud`` (float32 ``.bin`` reshape(-1, 5) ->
4 dims), ``RadarPointCloud`` (the OmniHD raw radar ``.bin`` is float32
x8 — the nuScenes PCD parser is vestigial; this reader handles the
actual format), ``LidarSegPointCloud``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class PointCloud:
    """d x n point cloud with rigid-transform helpers."""

    def __init__(self, points: np.ndarray):
        assert points.shape[0] == self.nbr_dims(), \
            f'Error: Pointcloud points must have format: {self.nbr_dims()} x n'
        self.points = points

    @staticmethod
    def nbr_dims() -> int:
        raise NotImplementedError

    @classmethod
    def from_file(cls, file_name: str) -> 'PointCloud':
        raise NotImplementedError

    def nbr_points(self) -> int:
        return self.points.shape[1]

    def subsample(self, ratio: float) -> None:
        assert 0 < ratio < 1
        sel = np.random.choice(np.arange(self.nbr_points()),
                               size=int(self.nbr_points() * ratio))
        self.points = self.points[:, sel]

    def remove_close(self, radius: float) -> None:
        keep = ~(np.logical_and(np.abs(self.points[0]) < radius,
                                np.abs(self.points[1]) < radius))
        self.points = self.points[:, keep]

    def translate(self, x: np.ndarray) -> None:
        for i in range(3):
            self.points[i] = self.points[i] + x[i]

    def rotate(self, rot_matrix: np.ndarray) -> None:
        self.points[:3] = rot_matrix @ self.points[:3]

    def transform(self, transf_matrix: np.ndarray) -> None:
        self.points[:3] = (transf_matrix @ np.vstack(
            (self.points[:3], np.ones(self.nbr_points()))))[:3]

    @classmethod
    def from_file_multisweep(cls, newsc, sample_rec: Dict,
                             chan_paths, ego_poses,
                             nsweeps: int = 5,
                             min_distance: float = 1.0
                             ) -> Tuple['PointCloud', np.ndarray]:
        """Aggregate sweeps into the reference frame of the first entry.

        chan_paths: [(file, sensor2ego 4x4, timestamp_us)] newest first;
        ego_poses: matching ego->global 4x4 per sweep.  Mirrors the
        devkit's chained 4-matrix transform with per-point time lag.
        """
        points = np.zeros((cls.nbr_dims(), 0))
        all_pc = cls(points)
        all_times = np.zeros((1, 0))

        ref_path, ref_s2e, ref_ts = chan_paths[0]
        ref_e2g = ego_poses[0]
        ref_from_global = np.linalg.inv(ref_e2g @ ref_s2e)

        for (path, s2e, ts), e2g in zip(chan_paths[:nsweeps],
                                        ego_poses[:nsweeps]):
            pc = cls.from_file(path)
            pc.remove_close(min_distance)
            pc.transform(ref_from_global @ e2g @ s2e)
            times = (ref_ts - ts) * 1e-6 * np.ones((1, pc.nbr_points()))
            all_times = np.hstack((all_times, times))
            all_pc.points = np.hstack((all_pc.points, pc.points))
        return all_pc, all_times


class LidarPointCloud(PointCloud):
    """OmniHD lidar ``.bin``: float32 x5, first 4 dims used."""

    @staticmethod
    def nbr_dims() -> int:
        return 4

    @classmethod
    def from_file(cls, file_name: str) -> 'LidarPointCloud':
        assert file_name.endswith('.bin'), f'Unsupported filetype {file_name}'
        scan = np.fromfile(file_name, dtype=np.float32)
        points = scan.reshape((-1, 5))[:, :cls.nbr_dims()]
        return cls(points.T)


class RadarPointCloud(PointCloud):
    """OmniHD 4D-radar ``.bin``: float32 x8
    [x, y, z, v_r, power, motion_state, SNR, valid_flag]."""

    @staticmethod
    def nbr_dims() -> int:
        return 8

    @classmethod
    def from_file(cls, file_name: str,
                  valid_only: bool = False) -> 'RadarPointCloud':
        assert file_name.endswith('.bin'), f'Unsupported filetype {file_name}'
        scan = np.fromfile(file_name, dtype=np.float32).reshape(-1, 8)
        if valid_only:
            scan = scan[scan[:, 7] > 0]
        return cls(scan.T.copy())


class LidarSegPointCloud:
    """Point cloud + per-point semantic labels."""

    def __init__(self, points_path: str = None, labels_path: str = None):
        self.points, self.labels = None, None
        if points_path:
            self.load_points(points_path)
        if labels_path:
            self.load_labels(labels_path)

    def load_points(self, path: str):
        self.points = LidarPointCloud.from_file(path).points.T

    def load_labels(self, path: str):
        self.labels = np.fromfile(path, dtype=np.uint8)
