"""SO(3)/SE(3) operations on batched tensors (port of ``visual_slam_tpu.ops.lie``).

Conventions as in the JAX package: poses are 4x4 ``T_w2c`` (world ->
camera), rotations 3x3, axis-angle vectors in radians. Every function
broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map (..., 3) -> (..., 3, 3), with the same
    branch-free small-angle Taylor guards as the JAX version."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    use_taylor = theta2 < 1e-8
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # The bottom row from t's own zeros and ones: a constant tensor would be
    # a host-to-device copy on every call.
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians from the trace."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(c)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix to M via SVD (det +1 enforced)."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    one = torch.ones_like(d)
    D = torch.stack([one, one, d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse: [R t]^-1 = [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return make_T(Rt, ti)
