"""SO(3)/SE(3) operations on batched tensors (port of ``visual_slam_tpu.ops.lie``).

Conventions as in the JAX package: poses are 4x4 ``T_w2c`` (world ->
camera), rotations 3x3, axis-angle vectors in radians, quaternions
``(w, x, y, z)``. Every function broadcasts over leading batch dimensions.
The small-angle guards are the JAX version's branch-free ``where``s, so the
functions stay differentiable (the pose graph takes their forward-mode
Jacobians at near-identity rotations).
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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map (..., 3, 3) -> (..., 3) by the quaternion route, stable
    across the whole range of angles including near pi."""
    return quat_to_rotvec(rotmat_to_quat(R))


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> axis-angle vector."""
    q = q * torch.sign(q[..., :1] + _EPS)  # hemisphere with w >= 0
    w, v = q[..., 0], q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.arctan2(vn, w)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / torch.where(small, 1.0, vn))
    return v * scale[..., None]


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free: the
    four Shepperd candidates, the best-conditioned one picked by argmax."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    vals = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    idx = torch.argmax(vals, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.sign(q[..., :1] + _EPS)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: twist (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    W = hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> twist (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    # V^-1 = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half) + _EPS)) / (theta2 + _EPS),
    )
    W = hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * (W @ W)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (the JAX package's ``inv_T``)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


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
