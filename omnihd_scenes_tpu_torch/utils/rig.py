"""Synthetic surround camera rig (counterpart of
``omnihd_scenes_tpu/utils/rig.py``): the geometry ``bench.py`` and the
smoke test feed the LSS view transform (``ring_rig_img2lidar``) and
BEVFormer's point sampling (``ring_rig_lidar2img``).

Six pinhole cameras at the OmniHD-Scenes headings {0, +-55, +-125, 180}
deg, each 1.5 m out from the origin along its heading and 1.6 m up,
looking outward, with f = 0.8 * W and the principal point at the image
centre.  ``tests/test_torch_port_config.py`` holds it equal to the JAX
package's rig.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

OMNIHD_CAMERA_YAWS = (0.0, 55.0, -55.0, 180.0, 125.0, -125.0)

# Camera axes (x right, y down, z forward) in ego axes (x forward, y left,
# z up).
_CAM_BASE = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]])


def _yaw_mat(yaw_rad: float) -> np.ndarray:
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _intrinsics(img_hw, focal_frac):
    h, w = img_hw
    return np.array([[focal_frac * w, 0.0, w / 2.0],
                     [0.0, focal_frac * w, h / 2.0],
                     [0.0, 0.0, 1.0]])


def ring_rig_lidar2img(img_hw: Tuple[int, int] = (544, 960),
                       yaws_deg: Sequence[float] = OMNIHD_CAMERA_YAWS,
                       focal_frac: float = 0.8,
                       cam_height: float = 1.6,
                       cam_radius: float = 1.5) -> np.ndarray:
    """(num_cam, 4, 4) float32 lidar2img of the same rig, the lidar frame
    taken as the ego frame (x forward, y left, z up)."""
    proj = np.eye(4)
    proj[:3, :3] = _intrinsics(img_hw, focal_frac)
    out = []
    for yaw in yaws_deg:
        cam2ego = np.eye(4)
        cam2ego[:3, :3] = _yaw_mat(np.deg2rad(yaw)) @ _CAM_BASE
        cam2ego[:3, 3] = _yaw_mat(np.deg2rad(yaw)) @ np.array(
            [cam_radius, 0.0, cam_height])
        out.append(proj @ np.linalg.inv(cam2ego))
    return np.asarray(out, np.float32)


def ring_rig_img2lidar(img_hw: Tuple[int, int] = (544, 960),
                       yaws_deg: Sequence[float] = OMNIHD_CAMERA_YAWS,
                       focal_frac: float = 0.8,
                       cam_height: float = 1.6,
                       cam_radius: float = 1.5):
    """(rots (N, 3, 3), trans (N, 3)) float32 in the LSS convention
    ``p_ego = rots @ (u*d, v*d, d) + trans`` (intrinsic inverse folded
    into the rotation)."""
    k_inv = np.linalg.inv(_intrinsics(img_hw, focal_frac))
    rots, trans = [], []
    for yaw in yaws_deg:
        rot = _yaw_mat(np.deg2rad(yaw)) @ _CAM_BASE       # cam->ego
        rots.append(rot @ k_inv)
        trans.append(_yaw_mat(np.deg2rad(yaw)) @ np.array(
            [cam_radius, 0.0, cam_height]))
    return (np.asarray(rots, np.float32), np.asarray(trans, np.float32))


def perturbed_rigs(rots, trans, batch: int, seed: int,
                   max_angle_deg: float = 2.0, max_shift: float = 0.2):
    """A rig (rots (N, 3, 3), trans (N, 3)) moved independently for every
    sample and camera, as calibration drift or extrinsic augmentation moves
    it: turned about the ego x, y and z axes by seeded angles within
    +-``max_angle_deg`` and shifted by up to ``max_shift`` m per axis.
    Returns (rots (batch, N, 3, 3), trans (batch, N, 3)) float32."""
    rng = np.random.RandomState(seed)
    rots = np.asarray(rots, np.float64)
    trans = np.asarray(trans, np.float64)
    out_r = np.empty((batch,) + rots.shape)
    out_t = np.empty((batch,) + trans.shape)
    for b in range(batch):
        for n in range(len(rots)):
            ax, ay, az = np.deg2rad(rng.uniform(-max_angle_deg,
                                                max_angle_deg, 3))
            cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
            turn = (_yaw_mat(az)
                    @ np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0],
                                [-sy, 0.0, cy]])
                    @ np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx],
                                [0.0, sx, cx]]))
            out_r[b, n] = turn @ rots[n]
            out_t[b, n] = turn @ trans[n] + rng.uniform(-max_shift,
                                                       max_shift, 3)
    return out_r.astype(np.float32), out_t.astype(np.float32)
