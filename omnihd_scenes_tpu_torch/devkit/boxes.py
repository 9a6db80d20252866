"""3D box data class for the OmniHD-Scenes devkit.

Parity target: ``Box`` in
``newscenes_devkit/data_classes.py:529-741`` — a 3D box
with center, wlh size, quaternion orientation, label/score/velocity plus
the OmniHD additions: camera ``visibility`` flag and ``track_id``.
Rendering is intentionally left to ``omnihd_scenes_tpu_torch.tools.visualize``.
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np

from omnihd_scenes_tpu_torch.utils.quaternion import Quaternion

# Unit-box corner pattern; x forward, y left, z up.  First four corners
# face forward, last four face backwards (reference convention).
_CORNER_SIGNS = np.array([
    # x (length)           y (width)            z (height)
    [1, 1, 1, 1, -1, -1, -1, -1],
    [1, -1, -1, 1, 1, -1, -1, 1],
    [1, 1, -1, -1, 1, 1, -1, -1],
], dtype=np.float64)


class Box:
    """3D box: center, wlh, orientation, velocity, visibility, track id."""

    def __init__(self,
                 center: List[float],
                 size: List[float],
                 orientation: Quaternion,
                 label: int = np.nan,
                 score: float = np.nan,
                 velocity: Tuple = (np.nan, np.nan, np.nan),
                 visibility: bool = True,
                 name: str = None,
                 track_id: int = np.nan):
        assert not np.any(np.isnan(center)), "box center may not be NaN"
        assert not np.any(np.isnan(size)), "box size may not be NaN"
        assert len(center) == 3 and len(size) == 3
        assert isinstance(orientation, Quaternion)

        self.center = np.array(center, dtype=np.float64)
        self.wlh = np.array(size, dtype=np.float64)
        self.orientation = orientation
        self.label = int(label) if not np.isnan(label) else label
        self.score = float(score) if not np.isnan(score) else score
        self.velocity = np.array(velocity, dtype=np.float64)
        self.visibility = visibility
        self.name = name
        self.track_id = int(track_id) if not np.isnan(track_id) else track_id

    # -- transforms --------------------------------------------------------
    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.orientation.rotation_matrix

    def translate(self, x: np.ndarray) -> None:
        self.center = self.center + x

    def rotate(self, quaternion: Quaternion) -> None:
        rot = quaternion.rotation_matrix
        self.center = rot @ self.center
        self.orientation = quaternion * self.orientation
        self.velocity = rot @ self.velocity

    # -- geometry -----------------------------------------------------------
    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 8) corner coordinates; first four corners face forward."""
        w, l, h = self.wlh * wlh_factor
        corners = _CORNER_SIGNS * np.array([[l], [w], [h]]) / 2.0
        corners = self.orientation.rotation_matrix @ corners
        return corners + self.center.reshape(3, 1)

    def bottom_corners(self) -> np.ndarray:
        """(3, 4) bottom corners; first two face forward."""
        return self.corners()[:, [2, 3, 7, 6]]

    # -- misc ---------------------------------------------------------------
    def copy(self) -> "Box":
        return copy.deepcopy(self)

    def __eq__(self, other):
        def _nan_eq(a, b):
            return (a == b) or (np.isnan(a) and np.isnan(b))

        return (np.allclose(self.center, other.center)
                and np.allclose(self.wlh, other.wlh)
                and self.orientation == other.orientation
                and _nan_eq(self.label, other.label)
                and _nan_eq(self.score, other.score)
                and (np.allclose(self.velocity, other.velocity)
                     or (np.all(np.isnan(self.velocity)) and np.all(np.isnan(other.velocity))))
                and _nan_eq(self.track_id, other.track_id))

    def __repr__(self):
        return (f"Box(label={self.label}, score={self.score}, "
                f"xyz={self.center.tolist()}, wlh={self.wlh.tolist()}, "
                f"yaw={self.orientation.yaw_pitch_roll[0]:.3f}, "
                f"vel={self.velocity.tolist()}, visibility={self.visibility}, "
                f"name={self.name}, track_id={self.track_id})")
