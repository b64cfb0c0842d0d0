"""Camera projection math (port of ``visual_slam_tpu.ops.projection``)."""
from __future__ import annotations

import torch

_EPS = 1e-9


def add_ones(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) homogeneous."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(K_inv: torch.Tensor, pts2d: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized image coordinates."""
    return (add_ones(pts2d) @ K_inv.transpose(-1, -2))[..., :2]


def project_points(
    K: torch.Tensor, T_w2c: torch.Tensor, pts3d_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> ``(uv (..., N, 2), z (..., N))``."""
    R, t = T_w2c[..., :3, :3], T_w2c[..., :3, 3]
    pc = pts3d_w @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    xy = pc[..., :2] / zs[..., None]
    uv = (add_ones(xy) @ K.transpose(-1, -2))[..., :2]
    return uv, z
