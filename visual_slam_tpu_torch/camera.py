"""Camera models: host-side numpy parameters and convenience API
(port of ``visual_slam_tpu.camera``, unchanged: it is pure numpy).

K/Kinv intrinsics, project/unproject, distortion, bounds checks, FOV
setters, stereo baseline. Batched device versions are in
``ops/projection.py``.
"""
from __future__ import annotations

import numpy as np

from .sensor_type import SensorType


class Camera:
    def __init__(
        self,
        width: int,
        height: int,
        K: np.ndarray,
        D: np.ndarray | None = None,
        fps: float = 30.0,
        sensor_type: SensorType = SensorType.MONOCULAR,
    ):
        self.width = int(width)
        self.height = int(height)
        self.K = np.asarray(K, np.float64).reshape(3, 3)
        self.Kinv = np.linalg.inv(self.K)
        self.D = np.zeros(5) if D is None else np.asarray(D, np.float64).ravel()[:5]
        if self.D.size < 5:
            self.D = np.pad(self.D, (0, 5 - self.D.size))
        self.fps = fps
        self.sensor_type = sensor_type

    # -- intrinsics accessors ----------------------------------------------
    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])

    def set_fov_deg(self, fov_x_deg: float, fov_y_deg: float | None = None) -> None:
        """FOV-based focal setters."""
        fx = self.width / (2.0 * np.tan(np.deg2rad(fov_x_deg) / 2.0))
        fy = (
            self.height / (2.0 * np.tan(np.deg2rad(fov_y_deg) / 2.0))
            if fov_y_deg is not None
            else fx
        )
        self.K[0, 0] = fx
        self.K[1, 1] = fy
        self.Kinv = np.linalg.inv(self.K)

    @property
    def fov_x_deg(self) -> float:
        return float(np.rad2deg(2.0 * np.arctan2(self.width, 2.0 * self.fx)))

    @property
    def has_distortion(self) -> bool:
        return bool(np.any(np.abs(self.D) > 1e-12))

    # -- projection --------------------------
    def project(self, pts3d_c: np.ndarray):
        """Camera-frame points -> (uv, depth)."""
        pts3d_c = np.atleast_2d(np.asarray(pts3d_c, np.float64))
        z = pts3d_c[:, 2]
        zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
        uv = (pts3d_c[:, :2] / zs[:, None]) @ self.K[:2, :2].T + self.K[:2, 2]
        return uv, z

    def unproject(self, uv: np.ndarray, depth: np.ndarray | float = 1.0) -> np.ndarray:
        """Pixels (+depth) -> camera-frame 3D points."""
        uv = np.atleast_2d(np.asarray(uv, np.float64))
        ones = np.ones((uv.shape[0], 1))
        rays = np.concatenate([uv, ones], axis=1) @ self.Kinv.T
        d = np.broadcast_to(np.asarray(depth, np.float64).reshape(-1, 1), (uv.shape[0], 1))
        return rays * d

    def unproject_points(self, uv: np.ndarray) -> np.ndarray:
        """Pixels -> normalized coords (x, y)."""
        uv = np.atleast_2d(np.asarray(uv, np.float64))
        ones = np.ones((uv.shape[0], 1))
        return (np.concatenate([uv, ones], axis=1) @ self.Kinv.T)[:, :2]

    def undistort_points(self, uv: np.ndarray, iters: int = 8) -> np.ndarray:
        """Iterative Brown-Conrady inversion, pixels -> pixels."""
        xy_d = self.unproject_points(uv)
        k1, k2, p1, p2, k3 = self.D
        xy = xy_d.copy()
        for _ in range(iters):
            x, y = xy[:, 0], xy[:, 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            xy = (xy_d - np.stack([dx, dy], 1)) / radial[:, None]
        return xy @ self.K[:2, :2].T + self.K[:2, 2]

    # -- bounds -------------------------------
    def is_in_image(self, uv: np.ndarray, margin: float = 0.0) -> bool:
        u, v = float(uv[0]), float(uv[1])
        return margin <= u < self.width - margin and margin <= v < self.height - margin

    def are_in_image(self, uvs: np.ndarray, margin: float = 0.0) -> np.ndarray:
        uvs = np.atleast_2d(uvs)
        return (
            (uvs[:, 0] >= margin)
            & (uvs[:, 0] < self.width - margin)
            & (uvs[:, 1] >= margin)
            & (uvs[:, 1] < self.height - margin)
        )


class PinholeCamera(Camera):
    """Adds the stereo baseline (bf = baseline * fx) and stereo projection."""

    def __init__(self, *args, baseline: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.baseline = float(baseline)

    @property
    def bf(self) -> float:
        return self.baseline * self.fx

    def project_stereo(self, pts3d_c: np.ndarray):
        """Returns (uv_left, u_right, depth)."""
        uv, z = self.project(pts3d_c)
        zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
        u_right = uv[:, 0] - self.bf / zs
        return uv, u_right, z

    def depth_from_disparity(self, disparity: np.ndarray) -> np.ndarray:
        d = np.where(np.abs(disparity) < 1e-9, 1e-9, disparity)
        return self.bf / d

    def undistort_image_bounds(self) -> np.ndarray:
        """Undistorted positions of the four image corners."""
        corners = np.array(
            [[0, 0], [self.width - 1, 0], [0, self.height - 1], [self.width - 1, self.height - 1]],
            np.float64,
        )
        return self.undistort_points(corners)
