"""SE(3) pose wrapper, host-side and numpy-backed (port of
``visual_slam_tpu.map.pose``).

4x4 storage, ``@`` composition, inverse, quaternion/euler export, factory
constructors, distance/angle metrics. Device code takes raw (4, 4) tensors.
"""
from __future__ import annotations

import numpy as np


class Pose:
    __slots__ = ("T",)

    def __init__(self, T: np.ndarray | None = None):
        self.T = np.eye(4, dtype=np.float64) if T is None else np.asarray(T, np.float64).reshape(4, 4)

    # -- factories ---------------------------------------------------------
    @classmethod
    def from_RT(cls, R: np.ndarray, t: np.ndarray) -> "Pose":
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = np.asarray(t).ravel()
        return cls(T)

    @classmethod
    def from_quaternion(cls, q: np.ndarray, t: np.ndarray) -> "Pose":
        """q = (w, x, y, z)."""
        w, x, y, z = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        return cls.from_RT(R, t)

    @classmethod
    def from_euler(cls, rpy: np.ndarray, t: np.ndarray) -> "Pose":
        r, p, y = rpy
        cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
        R = np.array(
            [
                [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                [-sp, cp * sr, cp * cr],
            ]
        )
        return cls.from_RT(R, t)

    # -- accessors ---------------------------------------------------------
    @property
    def R(self) -> np.ndarray:
        return self.T[:3, :3]

    @property
    def t(self) -> np.ndarray:
        return self.T[:3, 3]

    def inverse(self) -> "Pose":
        Rt = self.R.T
        return Pose.from_RT(Rt, -Rt @ self.t)

    def __matmul__(self, other: "Pose") -> "Pose":
        return Pose(self.T @ other.T)

    def quaternion(self) -> np.ndarray:
        """(w, x, y, z), w >= 0."""
        R = self.R
        tr = np.trace(R)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
        elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
        elif R[1, 1] > R[2, 2]:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])
        if q[0] < 0:
            q = -q
        return q / np.linalg.norm(q)

    def euler(self) -> np.ndarray:
        R = self.R
        pitch = np.arcsin(np.clip(-R[2, 0], -1, 1))
        roll = np.arctan2(R[2, 1], R[2, 2])
        yaw = np.arctan2(R[1, 0], R[0, 0])
        return np.array([roll, pitch, yaw])

    # -- metrics -----------------------------------------------------------
    def distance_to(self, other: "Pose") -> float:
        return float(np.linalg.norm(self.t - other.t))

    def angle_to(self, other: "Pose") -> float:
        dR = self.R.T @ other.R
        c = np.clip((np.trace(dR) - 1.0) * 0.5, -1.0, 1.0)
        return float(np.arccos(c))

    def copy(self) -> "Pose":
        return Pose(self.T.copy())

    def __repr__(self) -> str:
        return f"Pose(t={self.t.round(3).tolist()}, rpy={self.euler().round(3).tolist()})"
