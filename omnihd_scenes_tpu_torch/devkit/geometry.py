"""Geometry helpers for the OmniHD-Scenes ("NewScenes") devkit.

Functional parity with ``newscenes_devkit/geometry_utils.py``:
perspective/orthographic projection (``view_points``), box-in-image
visibility, pose -> 4x4 transform (``transform_matrix``), point-in-box
tests and Nx3 point transforms.  Pure float64 NumPy, no accelerator.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Tuple

import numpy as np

from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion


class BoxVisibility(IntEnum):
    """Levels of box visibility in an image."""

    ALL = 0    # All corners inside the image.
    ANY = 1    # At least one corner visible inside the image.
    NONE = 2   # No constraint; box may be fully outside.


def view_points(points: np.ndarray, view: np.ndarray, normalize: bool) -> np.ndarray:
    """Project 3D points (3, n) through an arbitrary <=4x4 view matrix.

    ``normalize=True`` divides by the third (depth) coordinate —
    perspective projection with a 3x3 intrinsic matrix.
    """
    assert view.shape[0] <= 4 and view.shape[1] <= 4
    assert points.shape[0] == 3

    viewpad = np.eye(4)
    viewpad[: view.shape[0], : view.shape[1]] = view

    n = points.shape[1]
    homo = np.concatenate((points, np.ones((1, n))))
    proj = (viewpad @ homo)[:3, :]

    if normalize:
        proj = proj / proj[2:3, :]
    return proj


def box_in_image(box, intrinsic: np.ndarray, imsize: Tuple[int, int],
                 vis_level: int = BoxVisibility.ANY) -> bool:
    """True if the box satisfies the visibility constraint in the image.

    ``imsize`` is (width, height).  Mirrors the reference semantics: a
    corner counts as visible when strictly inside the image bounds and
    more than 1 m in front of the camera; all corners must additionally
    be at least 0.1 m in front.
    """
    corners_3d = box.corners()
    corners_img = view_points(corners_3d, intrinsic, normalize=True)[:2, :]

    visible = (corners_img[0, :] > 0) & (corners_img[0, :] < imsize[0])
    visible &= (corners_img[1, :] > 0) & (corners_img[1, :] < imsize[1])
    visible &= corners_3d[2, :] > 1

    in_front = corners_3d[2, :] > 0.1

    if vis_level == BoxVisibility.ALL:
        return bool(np.all(visible) and np.all(in_front))
    if vis_level == BoxVisibility.ANY:
        return bool(np.any(visible) and np.all(in_front))
    if vis_level == BoxVisibility.NONE:
        return True
    raise ValueError(f"vis_level: {vis_level} not valid")


def transform_matrix(translation: np.ndarray = np.array([0.0, 0.0, 0.0]),
                     rotation: Quaternion = None,
                     inverse: bool = False) -> np.ndarray:
    """Pose (translation, quaternion) -> homogeneous 4x4 transform."""
    if rotation is None:
        rotation = Quaternion(1, 0, 0, 0)
    tm = np.eye(4)
    if inverse:
        rot_inv = rotation.rotation_matrix.T
        tm[:3, :3] = rot_inv
        tm[:3, 3] = rot_inv @ (-np.asarray(translation, dtype=np.float64))
    else:
        tm[:3, :3] = rotation.rotation_matrix
        tm[:3, 3] = np.asarray(translation, dtype=np.float64)
    return tm


def points_in_box(box, points: np.ndarray, wlh_factor: float = 1.0) -> np.ndarray:
    """Boolean mask of (3, n) points inside an (optionally inflated) box."""
    corners = box.corners(wlh_factor=wlh_factor)

    p1 = corners[:, 0]
    p_x = corners[:, 4]
    p_y = corners[:, 1]
    p_z = corners[:, 3]

    i = p_x - p1
    j = p_y - p1
    k = p_z - p1

    v = points - p1.reshape((-1, 1))

    iv = i @ v
    jv = j @ v
    kv = k @ v

    mask = (0 <= iv) & (iv <= i @ i)
    mask &= (0 <= jv) & (jv <= j @ j)
    mask &= (0 <= kv) & (kv <= k @ k)
    return mask


def transform_points(points_3d: np.ndarray, rt_matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 rigid transform to an (n, 3) point array."""
    out = points_3d @ rt_matrix[:3, :3].T
    return out + rt_matrix[:3, 3]
