"""Stereo rectification and dense undistortion / remap (port of
``visual_slam_tpu.ops.rectify``).

``stereo_rectify`` is host math run once per deployment (float64 numpy):
Bouguet-style rotations R1/R2 that make the baseline the rectified x-axis,
the shared K_new, P1/P2 and Q. ``undistort_rectify_map`` builds the dense
(2, H, W) source-pixel map of a rectified image, ``remap_bilinear``
resamples an image through it and ``rectify_pixels`` moves sparse
keypoints, all as tensor ops on their inputs' device.

Conventions: ``x2 = R @ x1 + T`` maps left-camera coordinates into the right
camera (Kalibr's ``T_cn_cnm1``); R1/R2 rotate each camera into its rectified
frame; camera 2 sits at +baseline on the rectified x-axis, as P2 and Q say.
"""
from __future__ import annotations

import numpy as np
import torch

from .projection import denormalize_points, distort_normalized, normalize_points, undistort_normalized


def stereo_rectify(K1, D1, K2, D2, R, T) -> dict:
    """Rectification of a raw calibrated rig. Returns dict(R1, R2, P1, P2, Q,
    K_new, baseline): R1/R2 rotate each camera into the common rectified
    orientation whose x-axis is the baseline, Q reprojects (u, v,
    disparity, 1) to 3D. The distortions take no part (the maps undo them)."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.ravel(np.asarray(T, np.float64))[:3]

    # Right-camera centre in left coordinates; rectified +x rides the
    # baseline toward camera 2, whatever its sign in left coordinates.
    C2 = -R.T @ T
    baseline = float(np.linalg.norm(C2))
    if baseline < 1e-12:
        raise ValueError("stereo_rectify: zero baseline")
    e1 = C2 / baseline
    # The "down" axis from the average optical axis of the two cameras, so
    # neither image takes the whole rectifying rotation.
    z_avg = np.array([0.0, 0.0, 1.0]) + R.T @ np.array([0.0, 0.0, 1.0])
    e2 = np.cross(z_avg, e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:  # degenerate: baseline along the optical axis
        e2 = np.cross(np.array([0.0, 1.0, 0.0]), e1)
        n2 = np.linalg.norm(e2)
    e2 = e2 / n2
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3 / np.linalg.norm(e3)])
    if np.linalg.det(R_rect) < 0:
        R_rect[1] = -R_rect[1]
    R1 = R_rect
    R2 = R_rect @ R.T

    # Shared rectified intrinsics: the average focal and principal point.
    f_new = 0.5 * (K1[0, 0] + K2[0, 0])
    cx = 0.5 * (K1[0, 2] + K2[0, 2])
    cy = 0.5 * (K1[1, 2] + K2[1, 2])
    K_new = np.array([[f_new, 0, cx], [0, f_new, cy], [0, 0, 1.0]])
    P1 = K_new @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K_new @ np.hstack([np.eye(3), np.array([[-baseline], [0.0], [0.0]])])
    Q = np.array([[1.0, 0, 0, -cx], [0, 1.0, 0, -cy], [0, 0, 0, f_new], [0, 0, 1.0 / baseline, 0]])
    return {"R1": R1, "R2": R2, "P1": P1, "P2": P2, "Q": Q, "K_new": K_new, "baseline": baseline}


def undistort_rectify_map(K: torch.Tensor, dist: torch.Tensor, R_rect: torch.Tensor, K_new: torch.Tensor,
                          height: int, width: int) -> torch.Tensor:
    """(2, H, W) source-pixel map of the rectified image: each rectified
    pixel unprojected through K_new, rotated back into the original camera
    (R_rect^T), distorted and projected through the original K; [0] holds
    x, [1] y. An identity R_rect and zero ``dist`` give a plain resample."""
    dev = K.device
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pts = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)  # (HW, 2)
    xy = normalize_points(torch.linalg.inv(K_new), pts)
    rays = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    rays_cam = rays @ R_rect  # == (R_rect^T ray)^T
    z = torch.where(torch.abs(rays_cam[:, 2]) < 1e-9, 1e-9, rays_cam[:, 2])
    uv_src = denormalize_points(K, distort_normalized(dist, rays_cam[:, :2] / z[:, None]))
    return uv_src.T.reshape(2, height, width)


def remap_bilinear(img: torch.Tensor, smap: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of ``img`` (H, W) at the (2, H', W') source map;
    samples outside clamp to the border."""
    H, W = img.shape
    x = torch.clamp(smap[0], 0.0, W - 1.001)
    y = torch.clamp(smap[1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    img_f = img.to(torch.float32)
    top = img_f[y0, x0] * (1.0 - fx) + img_f[y0, x0 + 1] * fx
    bot = img_f[y0 + 1, x0] * (1.0 - fx) + img_f[y0 + 1, x0 + 1] * fx
    return top * (1.0 - fy) + bot * fy


def rectify_pixels(K: torch.Tensor, dist: torch.Tensor, R_rect: torch.Tensor, K_new: torch.Tensor,
                   pts: torch.Tensor) -> torch.Tensor:
    """Sparse rectification of (N, 2) original-image pixels into the
    rectified image: undistort, rotate, reproject (the forward direction of
    ``undistort_rectify_map``)."""
    xy_u = undistort_normalized(dist, normalize_points(torch.linalg.inv(K), pts))
    rays = torch.cat([xy_u, torch.ones_like(xy_u[:, :1])], dim=-1)
    rays_r = rays @ R_rect.T
    z = torch.where(torch.abs(rays_r[:, 2]) < 1e-9, 1e-9, rays_r[:, 2])
    return denormalize_points(K_new, rays_r[:, :2] / z[:, None])
