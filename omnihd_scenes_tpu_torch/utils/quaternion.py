"""Minimal, dependency-free quaternion for rigid-body poses.

The reference stack leans on ``pyquaternion.Quaternion`` throughout
(``newscenes_devkit/newscenes.py:16``,
``data_classes.py``); only a small slice of its API is actually used:
construction from elements / (axis, radians), ``rotation_matrix``,
``inverse``, quaternion product, ``elements``, ``axis``, ``radians``,
``degrees`` and ``yaw_pitch_roll``.  This module provides exactly that
slice in float64 NumPy so the evaluation pipeline is bit-stable and the
devkit has no third-party geometry dependency.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


class Quaternion:
    """Unit quaternion stored as elements ``[w, x, y, z]`` (float64)."""

    __slots__ = ("q",)

    def __init__(self, *args, axis: Optional[Sequence[float]] = None,
                 radians: Optional[float] = None,
                 degrees: Optional[float] = None,
                 matrix: Optional[np.ndarray] = None):
        if axis is not None:
            if degrees is not None and radians is None:
                radians = float(np.deg2rad(degrees))
            angle = float(radians or 0.0)
            ax = np.asarray(axis, dtype=np.float64)
            n = np.linalg.norm(ax)
            if n == 0:
                raise ZeroDivisionError("Quaternion axis has zero norm")
            ax = ax / n
            half = angle / 2.0
            self.q = np.concatenate(([np.cos(half)], np.sin(half) * ax))
        elif matrix is not None:
            self.q = _matrix_to_quat(np.asarray(matrix, dtype=np.float64))
        elif len(args) == 0:
            self.q = np.array([1.0, 0.0, 0.0, 0.0])
        elif len(args) == 1:
            a = args[0]
            if isinstance(a, Quaternion):
                self.q = a.q.copy()
            else:
                arr = np.asarray(a, dtype=np.float64).reshape(-1)
                if arr.shape != (4,):
                    raise ValueError(f"need 4 elements, got {arr.shape}")
                self.q = arr.copy()
        elif len(args) == 4:
            self.q = np.array(args, dtype=np.float64)
        else:
            raise ValueError("Quaternion(): bad arguments")

    # -- accessors ---------------------------------------------------------
    @property
    def elements(self) -> np.ndarray:
        return self.q

    @property
    def w(self) -> float:
        return float(self.q[0])

    @property
    def x(self) -> float:
        return float(self.q[1])

    @property
    def y(self) -> float:
        return float(self.q[2])

    @property
    def z(self) -> float:
        return float(self.q[3])

    def norm(self) -> float:
        return float(np.linalg.norm(self.q))

    @property
    def axis(self) -> np.ndarray:
        v = self.q[1:]
        n = np.linalg.norm(v)
        if n < 1e-12:
            return np.array([0.0, 0.0, 0.0])
        return v / n

    @property
    def radians(self) -> float:
        n = self.norm()
        w = np.clip(self.q[0] / (n if n > 0 else 1.0), -1.0, 1.0)
        return float(2.0 * np.arccos(w))

    @property
    def degrees(self) -> float:
        return float(np.rad2deg(self.radians))

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q / self.norm()
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    @property
    def transformation_matrix(self) -> np.ndarray:
        tm = np.eye(4)
        tm[:3, :3] = self.rotation_matrix
        return tm

    @property
    def inverse(self) -> "Quaternion":
        conj = self.q * np.array([1.0, -1.0, -1.0, -1.0])
        return Quaternion(conj / float(np.dot(self.q, self.q)))

    @property
    def conjugate(self) -> "Quaternion":
        return Quaternion(self.q * np.array([1.0, -1.0, -1.0, -1.0]))

    @property
    def yaw_pitch_roll(self):
        """(yaw, pitch, roll) z-y'-x'' intrinsic Tait-Bryan angles."""
        w, x, y, z = self.q / self.norm()
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        sinp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
        pitch = np.arcsin(sinp)
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        return float(yaw), float(pitch), float(roll)

    # -- algebra -----------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Quaternion):
            w1, x1, y1, z1 = self.q
            w2, x2, y2, z2 = other.q
            return Quaternion(
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            )
        return NotImplemented

    def rotate(self, v: Iterable[float]) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    def normalised(self) -> "Quaternion":
        return Quaternion(self.q / self.norm())

    # -- misc --------------------------------------------------------------
    def __repr__(self):
        return f"Quaternion({self.q[0]:+.6f} {self.q[1]:+.6f}i {self.q[2]:+.6f}j {self.q[3]:+.6f}k)"

    def __eq__(self, other):
        if not isinstance(other, Quaternion):
            return NotImplemented
        return bool(np.allclose(self.q, other.q) or np.allclose(self.q, -other.q))

    def __iter__(self):
        return iter(self.q)

    def __getitem__(self, i):
        return self.q[i]

    def copy(self) -> "Quaternion":
        return Quaternion(self.q.copy())


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Shepperd's method: rotation matrix -> [w, x, y, z]."""
    m = m[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q
