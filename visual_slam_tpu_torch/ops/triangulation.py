"""Batched two-view triangulation and its geometric gates
(port of ``visual_slam_tpu.ops.triangulation``).

Everything is fixed-shape: callers pass validity masks instead of
shrinking arrays, so the chain runs the same launches every call, and on
CUDA tensors it reads nothing back to the host (``nullspace_vector`` takes
its direct method there).
"""
from __future__ import annotations

import torch

from .lie import inv_T
from .linalg import nullspace_vector
from .projection import normalize_points

_EPS = 1e-9


def triangulate_gated(
    Kinv: torch.Tensor,
    T_ref: torch.Tensor,
    T_cur: torch.Tensor,
    xy_ref: torch.Tensor,
    xy_cur: torch.Tensor,
    min_depth,
    max_depth,
    min_parallax_rad,
    reproj_thresh_n,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The keyframe-boundary triangulation chain: pixel -> normalized
    coordinates, DLT, depth and parallax gates, and a two-view reprojection
    gate (which drops matches that pass the descriptor tests but
    triangulate to points re-projecting badly in their own two views).
    Returns (pts3d (N, 3), good (N,))."""
    x_ref = normalize_points(Kinv, xy_ref)
    x_cur = normalize_points(Kinv, xy_cur)
    pts3d, w_ok = triangulate_dlt(projection_from_T(T_ref), projection_from_T(T_cur), x_ref, x_cur)
    good = w_ok & depth_mask(T_ref, T_cur, pts3d, min_depth, max_depth)
    good = good & (parallax_angles(T_ref, T_cur, pts3d) >= min_parallax_rad)

    def reproj_err2(T, x_obs):
        pc = pts3d @ T[:3, :3].T + T[:3, 3]
        z = torch.where(torch.abs(pc[:, 2]) < _EPS, _EPS, pc[:, 2])
        return torch.sum((pc[:, :2] / z[:, None] - x_obs) ** 2, dim=-1)

    t2 = reproj_thresh_n * reproj_thresh_n
    good = good & (reproj_err2(T_ref, x_ref) < t2) & (reproj_err2(T_cur, x_cur) < t2)
    return pts3d, good


def projection_from_T(T_w2c: torch.Tensor) -> torch.Tensor:
    """Normalized projection matrix P = [R|t] (3, 4) of a 4x4 world->camera pose."""
    return T_w2c[..., :3, :]


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear (DLT) triangulation of N correspondences in normalized
    coordinates: per point a 4x4 system, the smallest eigenvector of A^T A.
    ``P1``/``P2`` (..., 3, 4) may carry a batch of cameras (the JAX version
    ``vmap``s over them). Returns (pts3d_w (..., N, 3), w_ok (..., N)), w_ok
    the homogeneous-w validity."""

    def rows(P, x):
        P = P[..., None, :, :]  # (..., 1, 3, 4) against (N, 1) coordinates
        return x[..., 0:1] * P[..., 2, :] - P[..., 0, :], x[..., 1:2] * P[..., 2, :] - P[..., 1, :]

    A = torch.stack(torch.broadcast_tensors(*rows(P1, x1), *rows(P2, x2)), dim=-2)  # (..., N, 4, 4)
    Xh = nullspace_vector(A.transpose(-1, -2) @ A)
    w = Xh[..., 3]
    w_ok = torch.abs(w) > _EPS
    ws = torch.where(w_ok, w, 1.0)
    return Xh[..., :3] / ws[..., None], w_ok


def depths_in_cameras(
    T1_w2c: torch.Tensor, T2_w2c: torch.Tensor, pts3d_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depths of world points in both camera frames."""
    z1 = pts3d_w @ T1_w2c[..., 2, :3] + T1_w2c[..., 2, 3]
    z2 = pts3d_w @ T2_w2c[..., 2, :3] + T2_w2c[..., 2, 3]
    return z1, z2


def depth_mask(T1_w2c, T2_w2c, pts3d_w, min_depth, max_depth) -> torch.Tensor:
    """Points whose depth lies in (min, max) in BOTH cameras."""
    z1, z2 = depths_in_cameras(T1_w2c, T2_w2c, pts3d_w)
    return (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth) & (z2 < max_depth)


def parallax_angles(T1_w2c: torch.Tensor, T2_w2c: torch.Tensor, pts3d_w: torch.Tensor) -> torch.Tensor:
    """Per-point ray parallax angle (radians) between the two camera centers."""
    C1 = inv_T(T1_w2c)[..., :3, 3]
    C2 = inv_T(T2_w2c)[..., :3, 3]
    r1 = pts3d_w - C1[..., None, :]
    r2 = pts3d_w - C2[..., None, :]
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    cosang = torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=_EPS)
    return torch.arccos(torch.clamp(cosang, -1.0, 1.0))


def median_ray_parallax(
    R_rel: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Median angle between rotation-compensated viewing rays (the
    initializer's pre-triangulation parallax gate). ``x1``/``x2`` are
    normalized coordinates in the ref/cur frames; ``R_rel`` maps ref-camera
    rays into the cur camera; masked entries are ignored."""
    r1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    r2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    r1r = r1 @ R_rel.transpose(-1, -2)
    c = torch.sum(r1r * r2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(r1r, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=_EPS
    )
    return masked_median(torch.arccos(torch.clamp(c, -1.0, 1.0)), mask)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the entries where ``mask`` holds, along the last axis:
    the mean of the two middle values for an even count (not
    ``torch.median``, which returns the lower one); 0 when none holds."""
    n = mask.to(torch.int64).sum(-1)
    xs = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    top = torch.clamp(n - 1, min=0)
    lo = torch.gather(xs, -1, (top // 2)[..., None])[..., 0]
    hi = torch.gather(xs, -1, (top - top // 2)[..., None])[..., 0]
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.zeros_like(med))
