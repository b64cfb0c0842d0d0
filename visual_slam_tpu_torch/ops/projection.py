"""Camera projection math (port of ``visual_slam_tpu.ops.projection``).

Fixed-shape functions on batched point tensors ``(..., N, 2|3)`` with
intrinsics ``K (3, 3)`` and distortion ``dist (5,)`` in OpenCV order
(k1 k2 p1 p2 k3).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-9


def add_ones(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) homogeneous."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(K_inv: torch.Tensor, pts2d: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized image coordinates."""
    return (add_ones(pts2d) @ K_inv.transpose(-1, -2))[..., :2]


def denormalize_points(K: torch.Tensor, pts_norm: torch.Tensor) -> torch.Tensor:
    """Normalized image coordinates -> pixels."""
    return (add_ones(pts_norm) @ K.transpose(-1, -2))[..., :2]


def transform_points(T: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) (..., 4, 4) to points (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts3d @ R.transpose(-1, -2) + t[..., None, :]


def project_points(
    K: torch.Tensor, T_w2c: torch.Tensor, pts3d_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> ``(uv (..., N, 2), z (..., N))``."""
    return project_camera_points(K, transform_points(T_w2c, pts3d_w))


def project_camera_points(K: torch.Tensor, pts3d_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points -> pixels and depths."""
    z = pts3d_c[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    return denormalize_points(K, pts3d_c[..., :2] / zs[..., None]), z


def backproject(K_inv: torch.Tensor, pts2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depths -> camera-frame 3D points."""
    return unproject_points(K_inv, pts2d) * depth[..., None]


def unproject_points(K_inv: torch.Tensor, pts2d: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit-depth rays (x, y, 1)."""
    return add_ones(normalize_points(K_inv, pts2d))


def are_in_image(pts2d: torch.Tensor, width: int, height: int, margin: float = 0.0) -> torch.Tensor:
    """Bounds mask."""
    u, v = pts2d[..., 0], pts2d[..., 1]
    return (u >= margin) & (u < width - margin) & (v >= margin) & (v < height - margin)


def _distortion_terms(dist: torch.Tensor, xy: torch.Tensor):
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, torch.stack([dx, dy], dim=-1)


def distort_normalized(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential (Brown-Conrady) distortion to normalized coordinates."""
    radial, d = _distortion_terms(dist, xy)
    return xy * radial[..., None] + d


def undistort_normalized(dist: torch.Tensor, xy_d: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the distortion by a fixed number of fixed-point iterations."""
    xy = xy_d
    for _ in range(iters):
        radial, d = _distortion_terms(dist, xy)
        xy = (xy_d - d) / radial[..., None]
    return xy


def undistort_pixels(K: torch.Tensor, K_inv: torch.Tensor, dist: torch.Tensor, pts2d: torch.Tensor) -> torch.Tensor:
    """Undistort pixel coordinates, returning pixel coordinates under the same K."""
    return denormalize_points(K, undistort_normalized(dist, normalize_points(K_inv, pts2d)))


def reprojection_errors(
    K: torch.Tensor, T_w2c: torch.Tensor, pts3d_w: torch.Tensor, uv_obs: torch.Tensor
) -> torch.Tensor:
    """Per-point pixel reprojection error norms."""
    uv, _ = project_points(K, T_w2c, pts3d_w)
    return torch.linalg.vector_norm(uv - uv_obs, dim=-1)


def view_cos(T_w2c: torch.Tensor, pts3d_w: torch.Tensor) -> torch.Tensor:
    """Cosine between the camera's viewing axis and the ray to each point."""
    pc = transform_points(T_w2c, pts3d_w)
    n = torch.linalg.vector_norm(pc, dim=-1)
    return pc[..., 2] / torch.where(n < _EPS, _EPS, n)


def fov2focal(fov, pixels):
    return pixels / (2.0 * (torch.tan(fov * 0.5) if torch.is_tensor(fov) else math.tan(fov * 0.5)))


def focal2fov(focal, pixels):
    if torch.is_tensor(focal) or torch.is_tensor(pixels):
        return 2.0 * torch.atan2(torch.as_tensor(pixels), 2.0 * torch.as_tensor(focal))
    return 2.0 * math.atan2(pixels, 2.0 * focal)
