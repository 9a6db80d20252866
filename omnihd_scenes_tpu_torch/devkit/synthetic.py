"""Synthetic OmniHD-Scenes dataset generator.

The real dataset is ~1.3 TB and not available in CI, so this module
fabricates a small but schema-complete NewScenes database on disk:
JSON tables (``sample, sample_data, annotations, ego_pose, imu_data,
scene_split, sensor_calibration, meta``), lidar ``.bin`` sweeps
(float32 x5), 4D-radar ``.bin`` sweeps (float32 x8:
``[x,y,z,v_r,power,motion_state,SNR,valid_flag]``, reference
``loading.py:113``), six camera JPEGs per frame and occupancy ``.npz``
ground truth (key ``occ_gt``, (N,4) ``[i,j,k,cls]`` voxels, reference
``loading.py:97``).

Objects follow constant-velocity tracks in the global frame and the ego
drives forward, so geometry round-trips (velocity estimation, sweep
transforms, eval) are internally consistent.  Used by the test-suite and
the synthetic benchmark path.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List

import numpy as np

RAW_CATEGORIES = ['car', 'suv', 'van', 'truck', 'pedestrian', 'rider', 'bus',
                  'light_truck', 'tricyclist', 'engineering_vehicle',
                  'handcart', 'trailer']

CAMERA_TYPES = ['camera_front', 'camera_left_front', 'camera_right_front',
                'camera_back', 'camera_left_back', 'camera_right_back']
RADAR_TYPES = ['radar_front', 'radar_left_front', 'radar_right_front',
               'radar_back', 'radar_left_back', 'radar_right_back']

CAMERA_YAWS = {  # degrees, ego frame
    'camera_front': 0.0, 'camera_left_front': 55.0,
    'camera_right_front': -55.0, 'camera_back': 180.0,
    'camera_left_back': 125.0, 'camera_right_back': -125.0,
}
RADAR_YAWS = {
    'radar_front': 0.0, 'radar_left_front': 60.0, 'radar_right_front': -60.0,
    'radar_back': 180.0, 'radar_left_back': 120.0, 'radar_right_back': -120.0,
}

# Camera axes (x right, y down, z forward) expressed in ego axes
# (x forward, y left, z up).
_CAM_BASE = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]])


def _yaw_mat(yaw_rad: float) -> np.ndarray:
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rt(rot: np.ndarray, trans) -> List[float]:
    tm = np.eye(4)
    tm[:3, :3] = rot
    tm[:3, 3] = trans
    return tm.reshape(-1).tolist()


class SyntheticConfig:
    """Knobs for the synthetic dataset size."""

    def __init__(self,
                 n_scenes: int = 2,
                 samples_per_scene: int = 6,
                 n_lidar_points: int = 2048,
                 n_radar_points: int = 128,
                 n_objects: int = 8,
                 image_hw=(108, 192),
                 occ_voxels: int = 64,
                 dt_us: int = 500_000,
                 seed: int = 0,
                 cam_distortion=(0.0, 0.0, 0.0, 0.0, 0.0)):
        self.n_scenes = n_scenes
        self.samples_per_scene = samples_per_scene
        self.n_lidar_points = n_lidar_points
        self.n_radar_points = n_radar_points
        self.n_objects = n_objects
        self.image_hw = image_hw
        self.occ_voxels = occ_voxels
        self.dt_us = dt_us
        self.seed = seed
        # Opt-in lens distortion coefficients (k1,k2,p1,p2,k3) written
        # into the calibration tables.  Default zero: the rendered
        # images are pinhole, and golden-projection tests assume no
        # undistortion warp.  Nonzero values exercise the loader's
        # undistort remap path (host-pipeline benches / fast-vs-slow
        # decode agreement tests) — the pixels themselves are NOT
        # re-rendered with distortion, so only use this where the
        # image-to-GT alignment does not matter.
        self.cam_distortion = list(cam_distortion)


def _write_image(path: str, img: np.ndarray, draws) -> None:
    """Paint ``draws`` (depth, polygon, colour) far to near onto ``img``
    and write it as a JPEG (needs OpenCV)."""
    import cv2

    for _, poly, color in sorted(draws, key=lambda d: -d[0]):
        hull = cv2.convexHull(poly.reshape(-1, 1, 2))
        cv2.fillConvexPoly(img, hull, color)
    cv2.imwrite(path, img)


def generate(dataroot: str, version: str = 'v1.0-mini',
             cfg: SyntheticConfig = None, images: bool = True) -> Dict:
    """Write a synthetic NewScenes dataset under ``dataroot/version``.

    ``images=False`` writes no camera JPEG (and needs no OpenCV): the
    tables still name the image files, and every other file is the same
    byte for byte, since each image's noise is drawn from the generator's
    random stream either way.  It suits radar and LiDAR runs only.
    """
    cfg = cfg or SyntheticConfig()
    rng = np.random.RandomState(cfg.seed)
    table_root = osp.join(dataroot, version)
    os.makedirs(table_root, exist_ok=True)

    samples, sample_datas, annotations = [], [], []
    ego_poses, imu_datas, calibrations, metas = [], [], [], []
    scene_tokens = []

    h, w = cfg.image_hw
    # Simple pinhole intrinsics for the synthetic image size.
    intrinsic = [[w * 0.8, 0.0, w / 2.0],
                 [0.0, w * 0.8, h / 2.0],
                 [0.0, 0.0, 1.0]]
    distortion = list(cfg.cam_distortion)

    base_time_us = 1_700_000_000_000_000

    for s in range(cfg.n_scenes):
        scene_token = f'scene_{s:04d}'
        scene_tokens.append(scene_token)
        scene_dir = osp.join(dataroot, scene_token)
        for sub in ['lidar', 'occ_gt'] + CAMERA_TYPES + RADAR_TYPES:
            os.makedirs(osp.join(scene_dir, sub), exist_ok=True)

        # Per-scene calibration.
        calib = {}
        for cam in CAMERA_TYPES:
            rot = _yaw_mat(np.deg2rad(CAMERA_YAWS[cam])) @ _CAM_BASE
            trans = _yaw_mat(np.deg2rad(CAMERA_YAWS[cam])) @ np.array([1.5, 0, 1.6])
            calib[cam] = {'intrinsic': intrinsic, 'distortion': distortion,
                          'camera2ego': _rt(rot, trans)}
        for radar in RADAR_TYPES:
            rot = _yaw_mat(np.deg2rad(RADAR_YAWS[radar]))
            trans = rot @ np.array([2.0, 0, 0.6])
            calib[radar] = {'radar2ego': _rt(rot, trans)}
        calibrations.append({'token': scene_token, 'calib': calib})
        metas.append({'token': scene_token,
                      'meta': {'weather': 'rainy' if s % 2 else 'sunny',
                               'lighting': 'night' if s % 3 == 2 else 'day'}})

        # Ego trajectory: forward at ~5 m/s with gentle yaw.
        ego_speed = 5.0
        ego_yaw_rate = 0.02

        # Object tracks: constant global velocity.
        obj_centers0 = rng.uniform([-30, -20, -1], [30, 20, 1],
                                   size=(cfg.n_objects, 3))
        obj_vels = rng.uniform([-3, -3, 0], [3, 3, 0], size=(cfg.n_objects, 3))
        obj_sizes = rng.uniform([3.5, 1.6, 1.4], [6.0, 2.2, 2.2],
                                size=(cfg.n_objects, 3))  # (l, w, h)
        obj_yaws = rng.uniform(-np.pi, np.pi, size=cfg.n_objects)
        obj_cats = [RAW_CATEGORIES[i % len(RAW_CATEGORIES)]
                    for i in range(cfg.n_objects)]

        frame_tokens = []
        for f in range(cfg.samples_per_scene):
            t_us = base_time_us + s * 10_000_000_000 + f * cfg.dt_us
            frame_tokens.append(str(t_us))

        for f, token in enumerate(frame_tokens):
            t = f * cfg.dt_us * 1e-6
            ego_yaw = ego_yaw_rate * t
            ego_pos = np.array([ego_speed * t, 0.1 * t, 0.0])
            ego_rot = _yaw_mat(ego_yaw)
            pose_flat = _rt(ego_rot, ego_pos)

            pose_token = f'pose_{f:04d}'
            ego_poses.append({'token': pose_token, 'scene_token': scene_token,
                              'pose': pose_flat})
            imu_datas.append({
                'token': pose_token, 'scene_token': scene_token,
                'acc_xyz': [0.0, 0.0, 9.8],
                'gyro_xyz': [0.0, 0.0, ego_yaw_rate],
                'velocity_ego': [ego_speed, 0.1, 0.0],
            })

            # Object states in the ego frame at this timestamp (reused
            # by the sensor simulators below so returns lie ON objects).
            ego_rot_inv = ego_rot.T
            obj_ego = []
            for k in range(cfg.n_objects):
                center_global = obj_centers0[k] + obj_vels[k] * t
                center_ego = ego_rot_inv @ (center_global - ego_pos)
                vel_ego = ego_rot_inv @ (obj_vels[k]
                                         - np.array([ego_speed, 0.1, 0.0]))
                obj_ego.append((center_ego, obj_yaws[k] - ego_yaw,
                                obj_sizes[k], vel_ego))

            def object_surface_points(n_per_obj):
                """Points on object box surfaces (ego frame)."""
                pts, owners = [], []
                for k, (c, yaw, size, _) in enumerate(obj_ego):
                    if not (abs(c[0]) < 58 and abs(c[1]) < 38):
                        continue
                    local = rng.uniform(-0.5, 0.5, (n_per_obj, 3)) \
                        * size[[0, 1, 2]]
                    cy, sy = np.cos(yaw), np.sin(yaw)
                    x = local[:, 0] * cy - local[:, 1] * sy + c[0]
                    y = local[:, 0] * sy + local[:, 1] * cy + c[1]
                    z = local[:, 2] * 0 + rng.uniform(-0.5, 1.5, n_per_obj) \
                        * size[2] * 0.5 + c[2]
                    pts.append(np.stack([x, y, z], 1))
                    owners.extend([k] * n_per_obj)
                if pts:
                    return np.concatenate(pts), np.array(owners)
                return np.zeros((0, 3)), np.zeros((0,), int)

            # Files -----------------------------------------------------
            lidar_rel = f'{scene_token}/lidar/{token}.bin'
            n_bg = cfg.n_lidar_points * 3 // 4
            bg = rng.uniform([-55, -38, -2.5], [55, 38, 4.0],
                             size=(n_bg, 3)).astype(np.float32)
            obj_pts, _ = object_surface_points(
                max((cfg.n_lidar_points - n_bg) // max(cfg.n_objects, 1), 1))
            pts = np.concatenate([bg, obj_pts.astype(np.float32)])[
                :cfg.n_lidar_points]
            if len(pts) < cfg.n_lidar_points:
                pts = np.concatenate([pts, bg[:cfg.n_lidar_points - len(pts)]])
            lidar = np.concatenate(
                [pts, rng.uniform(0, 255, size=(len(pts), 1)),
                 np.zeros((len(pts), 1))], axis=1).astype(np.float32)
            lidar.tofile(osp.join(dataroot, lidar_rel))

            # Camera images with REAL signal: each object is rendered
            # as a class-colored filled box (projected corner hull) over
            # low-contrast noise, so camera-only detectors can genuinely
            # learn from the synthetic set (not just memorize noise).
            # Painter's algorithm by camera-frame depth.
            cams_rel = {}
            kmat = np.asarray(intrinsic)
            for cam in CAMERA_TYPES:
                img = rng.randint(96, 160, size=(h, w, 3), dtype=np.uint8)
                rel = f'{scene_token}/{cam}/{token}.jpg'
                cams_rel[cam] = rel
                if not images:
                    continue
                c2e = np.asarray(calib[cam]['camera2ego'],
                                 np.float64).reshape(4, 4)
                e2c_r, e2c_t = c2e[:3, :3].T, -c2e[:3, :3].T @ c2e[:3, 3]
                draws = []
                for k, (c, yaw, size, _) in enumerate(obj_ego):
                    cy, sy = np.cos(yaw), np.sin(yaw)
                    lx, wy, hz = size[0] / 2, size[1] / 2, size[2] / 2
                    corners = np.array(
                        [[sx * lx * cy - sy_ * wy * sy + c[0],
                          sx * lx * sy + sy_ * wy * cy + c[1],
                          c[2] + sz * hz]
                         for sx in (-1, 1) for sy_ in (-1, 1)
                         for sz in (-1, 1)])
                    pc = (e2c_r @ corners.T).T + e2c_t
                    vis = pc[:, 2] > 0.5
                    if vis.sum() < 3:
                        continue
                    uv = (kmat @ pc[vis].T).T
                    uv = uv[:, :2] / uv[:, 2:3]
                    if (uv[:, 0].max() < 0 or uv[:, 0].min() > w
                            or uv[:, 1].max() < 0 or uv[:, 1].min() > h):
                        continue
                    col_rng = np.random.RandomState(
                        RAW_CATEGORIES.index(obj_cats[k]) * 7 + 13)
                    color = tuple(int(v) for v in col_rng.randint(0, 255, 3))
                    draws.append((float(pc[vis, 2].mean()),
                                  np.clip(uv, -4 * w, 4 * w)
                                  .astype(np.int32), color))
                _write_image(osp.join(dataroot, rel), img, draws)

            radars_rel = {}
            ego_vel_ego = np.array([ego_speed, 0.1, 0.0])
            for radar in RADAR_TYPES:
                rel = f'{scene_token}/{radar}/{token}.bin'
                n = cfg.n_radar_points
                r_rot = _yaw_mat(np.deg2rad(RADAR_YAWS[radar]))
                r_trans = r_rot @ np.array([2.0, 0, 0.6])
                # Background clutter (sensor frame, forward-looking).
                n_bg = n // 2
                rpts = np.zeros((n, 8), dtype=np.float32)
                rpts[:n_bg, 0] = rng.uniform(1, 80, n_bg)
                rpts[:n_bg, 1] = rng.uniform(-30, 30, n_bg)
                rpts[:n_bg, 2] = rng.uniform(-1, 3, n_bg)
                rpts[:n_bg, 3] = rng.uniform(-10, 10, n_bg)
                # Object reflections with physically consistent radial
                # velocity (relative velocity projected on the line of
                # sight, measured in the sensor frame) — exercises the
                # loader's ego-motion Doppler compensation end to end.
                obj_pts, owners = object_surface_points(
                    max(n_bg // max(cfg.n_objects, 1), 1))
                m = min(len(obj_pts), n - n_bg)
                if m > 0:
                    p_sensor = (obj_pts[:m] - r_trans) @ r_rot
                    # obj_ego[k][3] is already relative to the ego.
                    rel_vel = np.stack([obj_ego[k][3] for k in owners[:m]])
                    v_sensor = rel_vel @ r_rot
                    los = p_sensor / np.clip(np.linalg.norm(
                        p_sensor, axis=1, keepdims=True), 1e-6, None)
                    rpts[n_bg:n_bg + m, 0:3] = p_sensor
                    rpts[n_bg:n_bg + m, 3] = np.sum(v_sensor * los, axis=1)
                rpts[:, 4] = rng.uniform(5, 40, n)      # power
                rpts[:, 5] = rng.randint(0, 2, n)       # motion_state
                rpts[:, 6] = rng.uniform(2, 30, n)      # SNR
                rpts[:, 7] = 1.0                        # valid_flag
                rpts.tofile(osp.join(dataroot, rel))
                radars_rel[radar] = rel

            # Occupancy GT: sparse (N,4) [i,j,k,cls] voxels.
            occ_rel = f'{scene_token}/occ_gt/{token}.npz'
            occ = np.zeros((cfg.occ_voxels, 4), dtype=np.int32)
            occ[:, 0] = rng.randint(0, 240, cfg.occ_voxels)
            occ[:, 1] = rng.randint(0, 160, cfg.occ_voxels)
            occ[:, 2] = rng.randint(0, 16, cfg.occ_voxels)
            occ[:, 3] = rng.randint(1, 12, cfg.occ_voxels)
            np.savez(osp.join(dataroot, occ_rel), occ_gt=occ)

            # Tables -----------------------------------------------------
            samples.append({
                'token': token,
                'prev': frame_tokens[f - 1] if f > 0 else '',
                'next': frame_tokens[f + 1] if f + 1 < len(frame_tokens) else '',
                'scene_token': scene_token,
                'frame_idx': f,
                'timestamp': int(token),
            })
            sample_datas.append({
                'token': token,
                'prev': frame_tokens[f - 1] if f > 0 else '',
                'next': frame_tokens[f + 1] if f + 1 < len(frame_tokens) else '',
                'scene_token': scene_token,
                'ego_pose': {'lidar_top_compensation': pose_token,
                             **{r: pose_token for r in RADAR_TYPES}},
                'lidar': {'lidar_top_compensation': lidar_rel},
                'cameras': cams_rel,
                'radars': radars_rel,
            })

            # Annotations in the EGO frame at this timestamp.
            global_to_ego_rot = ego_rot.T
            annos = []
            for k in range(cfg.n_objects):
                center_global = obj_centers0[k] + obj_vels[k] * t
                center_ego = global_to_ego_rot @ (center_global - ego_pos)
                if not (abs(center_ego[0]) < 70 and abs(center_ego[1]) < 55):
                    continue
                yaw_ego = obj_yaws[k] - ego_yaw
                annos.append({
                    'id': k,
                    'category': obj_cats[k],
                    'center': {'x': float(center_ego[0]),
                               'y': float(center_ego[1]),
                               'z': float(center_ego[2])},
                    # size.x = length, size.y = width (devkit reorders to wlh).
                    'size': {'x': float(obj_sizes[k][0]),
                             'y': float(obj_sizes[k][1]),
                             'z': float(obj_sizes[k][2])},
                    'rotation': {'z': float(yaw_ego)},
                    # Keep every eval class represented among visible
                    # tracks (k=6 is 'bus'; large_vehicle still has k=3, k=7).
                    'visibility': 1 if k != 6 else 0,
                })
            annotations.append({'token': token, 'annotations': annos})

    # Splits: alternate scenes between train and val.
    train = scene_tokens[0::2]
    val = scene_tokens[1::2] or scene_tokens[:1]
    scene_split = {'train': train, 'val': val,
                   'train_mini': train, 'val_mini': val,
                   'test': scene_tokens}

    tables = {
        'sample': samples,
        'sample_data': sample_datas,
        'annotations': annotations,
        'ego_pose': ego_poses,
        'imu_data': imu_datas,
        'sensor_calibration': calibrations,
        'meta': metas,
        'scene_split': scene_split,
    }
    for name, table in tables.items():
        with open(osp.join(table_root, f'{name}.json'), 'w') as f:
            json.dump(table, f)
    return tables
