"""OmniHD-Scenes ("NewScenes") database: JSON tables + reverse index.

Parity target: ``NewScenes`` in
``newscenes_devkit/newscenes.py:34-277``.

The on-disk layout is ``{dataroot}/{version}/{table}.json`` with tables
``sample, sample_data, annotations, ego_pose, imu_data, scene_split,
sensor_calibration, meta``.  ``ego_pose`` and ``imu_data`` tokens are
only unique within a scene, so their reverse index is keyed by
``scene_token + '_' + token`` (reference ``newscenes.py:115-118``).

Sample tokens are microsecond timestamps encoded as strings; velocity
estimation converts them with ``1e-6 * int(token)``
(reference ``newscenes.py:227-245``).
"""

from __future__ import annotations

import json
import os.path as osp
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from omnihd_scenes_tpu_torch.devkit.boxes import Box
from omnihd_scenes_tpu_torch.devkit.geometry import transform_points
from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

TABLE_NAMES = ('sample', 'sample_data', 'annotations', 'ego_pose',
               'imu_data', 'sensor_calibration', 'meta')
_SCENE_SCOPED_TABLES = ('imu_data', 'ego_pose')


class NewScenes:
    """Query interface over the OmniHD-Scenes JSON tables."""

    def __init__(self,
                 version: str = 'v1.0-mini',
                 dataroot: str = '/data/newscenes-mini',
                 verbose: bool = True,
                 map_resolution: float = 0.1):
        self.version = version
        self.dataroot = dataroot
        self.verbose = verbose
        self.table_names = list(TABLE_NAMES)

        assert osp.exists(self.table_root), \
            f'Database version not found: {self.table_root}'

        start = time.time()
        for table in self.table_names + ['scene_split']:
            setattr(self, table, self.__load_table__(table))

        if verbose:
            print(f"Loading NewScenes tables for version {self.version}")
            for table in self.table_names:
                print(f"{len(getattr(self, table))} {table},")
            print(f"Done loading in {time.time() - start:.3f} seconds.")

        self.__make_reverse_index__(verbose)

    @property
    def table_root(self) -> str:
        return osp.join(self.dataroot, self.version)

    def __load_table__(self, table_name: str) -> list:
        with open(osp.join(self.table_root, f'{table_name}.json')) as f:
            return json.load(f)

    def __make_reverse_index__(self, verbose: bool) -> None:
        self._token2ind: Dict[str, Dict[str, int]] = {}
        for table in self.table_names:
            index = {}
            if table in _SCENE_SCOPED_TABLES:
                for ind, member in enumerate(getattr(self, table)):
                    index[member['scene_token'] + '_' + member['token']] = ind
            else:
                for ind, member in enumerate(getattr(self, table)):
                    index[member['token']] = ind
            self._token2ind[table] = index

    # -- record access -------------------------------------------------------
    def get(self, table_name: str, token: str, scene_token: str = None) -> dict:
        """Constant-time record lookup."""
        assert table_name in self.table_names, f"Table {table_name} not found"
        return getattr(self, table_name)[self.getind(table_name, token, scene_token)]

    def getind(self, table_name: str, token: str, scene_token: str = None) -> int:
        if table_name in _SCENE_SCOPED_TABLES:
            assert scene_token is not None, \
                "scene_token is needed for imu_data and ego_pose"
            return self._token2ind[table_name][scene_token + '_' + token]
        return self._token2ind[table_name][token]

    # -- annotation boxes ------------------------------------------------------
    def get_annotation_box(self, sample_token: str) -> List[Box]:
        """Annotation boxes of a sample in the ego/lidar frame.

        Box size is stored (x, y, z) per-axis extent and re-ordered to
        (w=y, l=x, h=z); orientation is yaw-only about +z; velocity is
        estimated per track in the global frame and rotated into ego
        (reference ``newscenes.py:159-187``).
        """
        record = self.get('annotations', sample_token)['annotations']
        sync = self.get('sample_data', sample_token)
        scene_token = self.get('sample', sample_token)['scene_token']
        ego_pose = self.get('ego_pose', sync['ego_pose']['lidar_top_compensation'],
                            scene_token)['pose']
        ego_pose = np.array(ego_pose).reshape(4, 4)
        global_to_ego = np.linalg.inv(ego_pose)

        velocity_by_track = self.box_velocity(sample_token)

        boxes = []
        for box in record:
            center = [box['center']['x'], box['center']['y'], box['center']['z']]
            size = [box['size']['y'], box['size']['x'], box['size']['z']]
            orientation = Quaternion(axis=[0, 0, 1], radians=box['rotation']['z'])
            vel_global = velocity_by_track[box['id']]
            vel_ego = vel_global @ global_to_ego[:3, :3].T
            boxes.append(Box(center=center, size=size, orientation=orientation,
                             velocity=vel_ego, visibility=box['visibility'],
                             name=box['category'], track_id=box['id']))
        return boxes

    def box_velocity(self, sample_token: str,
                     max_time_diff: float = 1.5) -> "OrderedDict[int, np.ndarray]":
        """Per-track global-frame velocity via centered finite differences.

        Uses prev+next frames when the track exists in both (allowing
        2x the time window), otherwise one-sided differences; NaN when
        the track exists in neither neighbour or the gap is too large.
        """
        out = OrderedDict()
        prev_token = self.get('sample', sample_token)['prev']
        next_token = self.get('sample', sample_token)['next']

        prev_centers = self.transform_anno_center_to_global(prev_token) if prev_token != '' else {}
        next_centers = self.transform_anno_center_to_global(next_token) if next_token != '' else {}
        cur_centers = self.transform_anno_center_to_global(sample_token)

        for track_id, center in cur_centers.items():
            window = max_time_diff
            in_prev, in_next = track_id in prev_centers, track_id in next_centers
            if not in_prev and not in_next:
                out[track_id] = np.array([np.nan, np.nan, np.nan])
                continue
            if in_prev and in_next:
                pos_first, pos_last = prev_centers[track_id], next_centers[track_id]
                t_first, t_last = 1e-6 * int(prev_token), 1e-6 * int(next_token)
                window *= 2
            elif in_prev:
                pos_first, pos_last = prev_centers[track_id], np.asarray(center)
                t_first, t_last = 1e-6 * int(prev_token), 1e-6 * int(sample_token)
            else:
                pos_first, pos_last = np.asarray(center), next_centers[track_id]
                t_first, t_last = 1e-6 * int(sample_token), 1e-6 * int(next_token)

            time_diff = t_last - t_first
            if time_diff > window:
                out[track_id] = np.array([np.nan, np.nan, np.nan])
            else:
                out[track_id] = (np.asarray(pos_last) - np.asarray(pos_first)) / time_diff
        return out

    def transform_anno_center_to_global(self, sample_token: str) -> "OrderedDict[int, np.ndarray]":
        """Track-id -> global-frame annotation center for one sample."""
        annos = self.get('annotations', sample_token)['annotations']
        sync = self.get('sample_data', sample_token)
        scene_token = self.get('sample', sample_token)['scene_token']
        pose = self.get('ego_pose', sync['ego_pose']['lidar_top_compensation'],
                        scene_token)['pose']
        pose = np.array(pose).reshape(4, 4)

        if not annos:
            return OrderedDict()
        centers_ego = np.array([[b['center']['x'], b['center']['y'], b['center']['z']]
                                for b in annos])
        ids = [b['id'] for b in annos]
        centers_global = transform_points(centers_ego, pose)
        return OrderedDict(zip(ids, centers_global))
