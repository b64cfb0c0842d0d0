"""Perspective-n-Point pose estimation: fixed-budget RANSAC over DLT
hypotheses + Gauss-Newton SE(3) refinement (port of ``visual_slam_tpu.ops.pnp``).

The JAX version ``vmap``s over hypotheses; here every function takes
leading batch dimensions instead, so the 128 hypotheses are one batch, and
``ransac_pnp`` takes a leading batch of problems (the batched VO step's
sequences) beside them. On CUDA tensors no function reads a value back to
the host: the DLT's nullvector comes from ``nullspace_vector``'s direct
method and its pose from the closed forms (``_dlt_pose_closed``).

The stereo and RGB-D variants (``refine_pose_gn_depth``,
``ransac_pnp_depth``) add the normalized-disparity residual of each point
with a measured depth to the same solves: ``refine_pose_gn`` and
``ransac_pnp`` take the depth terms as optional arguments, so mono and
depth share one body and the mono path computes what it did.
"""
from __future__ import annotations

import torch

from .batch import take_rows
from .epipolar import _sample_minimal_sets
from .lie import det3x3, make_T, project_to_so3, project_to_so3_newton, so3_exp
from .linalg import nullspace_vector

_EPS = 1e-9


def pnp_dlt(
    pts3d: torch.Tensor, xy: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted DLT pose from (..., N, 3) points and (..., N, 2) normalized
    observations with (..., N) weights; needs >= 6 effective points.
    Returns (R (..., 3, 3), t (..., 3)) world -> camera, cheirality fixed
    so the weighted mean depth is positive."""
    p = nullspace_vector(_dlt_gram(pts3d, xy, w))
    P = p.reshape(p.shape[:-1] + (3, 4))
    return _dlt_pose(P[..., :, :3], P[..., :, 3], pts3d, w)


def _dlt_gram(pts3d: torch.Tensor, xy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The DLT's weighted normal matrix A^T W A (..., 12, 12): two rows a
    point, [X Y Z 1 0 0 0 0 -uX -uY -uZ -u] and [0 0 0 0 X Y Z 1 -vX -vY -vZ -v]."""
    X, Y, Z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    u, v = xy[..., 0], xy[..., 1]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 12)
    ww = torch.cat([w, w], dim=-1)
    return (A * ww[..., None]).transpose(-1, -2) @ A


def _dlt_pose(M, p4, pts3d, w):
    """The DLT fit's pose from its projection matrix [M | p4]: the SVD route
    on CPU tensors (the JAX function's, bit for bit as before), the closed
    forms on CUDA tensors, where an SVD reads its error status back to the
    host."""
    return (_dlt_pose_closed if M.is_cuda else _dlt_pose_svd)(M, p4, pts3d, w)


def _dlt_pose_svd(M, p4, pts3d, w):
    """Scale by the geometric mean of M's singular values and the sign of
    its determinant, the SVD projection onto SO(3), and the cheirality flip
    re-projected by SVD (as the JAX function)."""
    s = torch.linalg.svdvals(M)
    lam = torch.clamp(torch.exp(torch.mean(torch.log(torch.clamp(s, min=_EPS)), dim=-1)), min=_EPS)
    sign = torch.sign(torch.linalg.det(M))
    sign = torch.where(sign == 0, 1.0, sign)
    scale = (lam * sign)[..., None]
    R = project_to_so3(M / scale[..., None])
    t = p4 / scale
    z = (pts3d @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    flip = torch.sum(z * w, dim=-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    R = project_to_so3(R)
    t = torch.where(flip[..., None], -t, t)
    return R, t


def _dlt_pose_closed(M, p4, pts3d, w):
    """``_dlt_pose_svd`` without an SVD (a departure from the JAX function,
    which keeps its SVDs on every backend): the geometric mean of the
    singular values is |det M|^(1/3) exactly, and M / (lam sign) has det 1,
    so Newton's polar iteration projects it. The cheirality flip's -R is
    improper, and every rotation R H with H a half turn is nearest to it
    (its singular values are all 1; the SVD returns one of them
    arbitrarily). This route takes the half turn about the camera's x axis,
    diag(1, -1, -1) R, whose third row is -R's: the depths the flip made
    positive stay positive."""
    det = det3x3(M)
    lam = torch.clamp(torch.abs(det) ** (1.0 / 3.0), min=_EPS)
    sign = torch.sign(det)
    sign = torch.where(sign == 0, 1.0, sign)
    scale = (lam * sign)[..., None]
    R = project_to_so3_newton(M / scale[..., None])
    t = p4 / scale
    z = (pts3d @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    flip = torch.sum(z * w, dim=-1) < 0
    R = torch.where(flip[..., None, None], torch.cat([R[..., :1, :], -R[..., 1:, :]], dim=-2), R)
    t = torch.where(flip[..., None], -t, t)
    return R, t


def _reproj_err2(R: torch.Tensor, t: torch.Tensor, pts3d: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Squared reprojection error in normalized coordinates, (..., N);
    points behind the camera get 1e6."""
    pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    proj = pc[..., :2] / zs[..., None]
    e2 = torch.sum((proj - xy) ** 2, dim=-1)
    return torch.where(z > _EPS, e2, 1e6)


def refine_pose_gn(
    R0: torch.Tensor,
    t0: torch.Tensor,
    pts3d: torch.Tensor,
    xy: torch.Tensor,
    w: torch.Tensor,
    iters: int = 8,
    huber: torch.Tensor | float = 3e-3,
    damping: float = 1e-6,
    z_meas: torch.Tensor | None = None,
    w_z: torch.Tensor | None = None,
    baseline: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped Huber-IRLS Gauss-Newton on SE(3), left update T <- exp(xi) T,
    fixed iteration count. R0 (..., 3, 3) and t0 (..., 3) may carry a
    batch of poses; ``w`` (..., N) broadcasts against it. With ``z_meas``
    (..., N) measured camera depths and their weights ``w_z``, each point
    also adds the residual ``baseline * (1/z_hat - 1/z_meas)`` (see
    ``refine_pose_gn_depth``)."""
    R, t = R0, t0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    if z_meas is not None:
        inv_zm = 1.0 / torch.clamp(z_meas, min=_EPS)
    for _ in range(iters):
        pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
        inv_z = 1.0 / zs
        u = x * inv_z
        v = y * inv_z
        r = torch.stack([u - xy[..., 0], v - xy[..., 1]], dim=-1)  # (..., N, 2)
        zero = torch.zeros_like(u)
        Ju = torch.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], dim=-1)
        Jv = torch.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], dim=-1)
        rn = torch.linalg.vector_norm(r, dim=-1)
        hw = torch.where(rn <= huber, 1.0, huber / torch.clamp(rn, min=_EPS))
        ww = w * hw * (z > _EPS)
        J = torch.stack([Ju, Jv], dim=-2)  # (..., N, 2, 6)
        JtJ = torch.einsum("...nif,...n,...nig->...fg", J, ww, J)
        Jtr = torch.einsum("...nif,...n,...ni->...f", J, ww, r)
        if z_meas is not None:
            # d(1/z)/d(rho) = [0, 0, -1/z^2]; d(1/z)/d(phi) = -1/z^2 [y, -x, 0]
            # (left perturbation, dp/dxi = [I | -hat(p)]).
            rz = baseline * (inv_z - inv_zm)
            Jz = baseline * torch.stack([zero, zero, -inv_z * inv_z, -v * inv_z, u * inv_z, zero], dim=-1)
            az = torch.abs(rz)
            hz = torch.where(az <= huber, 1.0, huber / torch.clamp(az, min=_EPS))
            wz = w * w_z * hz * (z > _EPS)
            JtJ = JtJ + torch.einsum("...nf,...n,...ng->...fg", Jz, wz, Jz)
            Jtr = Jtr + torch.einsum("...nf,...n,...n->...f", Jz, wz, rz)
        # SPD damped normal equations: Cholesky and two triangular solves.
        # cholesky_ex reads no error status back to the host, which
        # linalg.cholesky does on every call.
        L, _ = torch.linalg.cholesky_ex(JtJ + damping * eye6)
        y = torch.linalg.solve_triangular(L, Jtr[..., None], upper=False)
        xi = -torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
        dT = so3_exp(xi[..., 3:])
        R = dT @ R
        t = (dT @ t[..., None])[..., 0] + xi[..., :3]
    return R, t


def refine_pose_gn_depth(
    R0: torch.Tensor,
    t0: torch.Tensor,
    pts3d: torch.Tensor,
    xy: torch.Tensor,
    w: torch.Tensor,
    z_meas: torch.Tensor,
    w_z: torch.Tensor,
    baseline: float,
    iters: int = 8,
    huber: torch.Tensor | float = 3e-3,
    damping: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton SE(3) refinement with a stereo / RGB-D depth residual:
    beside the reprojection residuals, each point with a measured depth
    ``z_meas`` (weight ``w_z``, 0/1) adds ORB-SLAM2's rectified-stereo
    residual in normalized units, ``r_z = b (1/z_hat - 1/z_meas)`` with
    ``b = baseline`` in metres (the real baseline, or RGB-D's virtual one):
    the normalized disparity error, commensurate with the reprojection
    residuals, which pins translation along the optical axis and metric
    scale every frame."""
    return refine_pose_gn(R0, t0, pts3d, xy, w, iters=iters, huber=huber, damping=damping, z_meas=z_meas,
                          w_z=w_z, baseline=baseline)


def _depth_err2(R: torch.Tensor, t: torch.Tensor, pts3d: torch.Tensor, z_meas: torch.Tensor,
                baseline: float) -> torch.Tensor:
    """Squared normalized-disparity error of the depth measurements, (..., N);
    points behind the camera get 1e6."""
    z = (pts3d @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    rz = baseline * (1.0 / zs - 1.0 / torch.clamp(z_meas, min=_EPS))
    return torch.where(z > _EPS, rz * rz, 1e6)


def ransac_pnp(
    pts3d: torch.Tensor,
    xy: torch.Tensor,
    mask: torch.Tensor,
    gen=None,
    n_hyp: int = 256,
    thresh: torch.Tensor | float = 6e-3,
    refine_iters: int = 8,
    sample_idx: torch.Tensor | None = None,
    z_meas: torch.Tensor | None = None,
    z_valid: torch.Tensor | None = None,
    baseline: float = 0.0,
) -> dict:
    """Fixed-budget RANSAC PnP in normalized image coordinates: ``n_hyp``
    6-point DLT hypotheses, two Huber-GN steps each (LO-RANSAC), truncated
    cost, argmin, then a GN polish on the winner's inliers.

    The minimal sets come from ``gen``, or are given as ``sample_idx``
    (n_hyp, 6) in its place (the tests feed the JAX sampler's draws).
    Returns dict(R, t, T (4, 4), inliers (N,), n_inliers, ok). With a
    leading batch on ``pts3d`` (B, N, 3), ``xy`` and ``mask`` (B problems
    solved at once), ``gen`` is a sequence of B generators, ``sample_idx``
    (B, n_hyp, 6), and every output carries the leading B. With ``z_meas``
    and ``z_valid`` (..., N), the local optimization, the cost and the
    polish also hold the depth residual (``ransac_pnp_depth``); inliers stay
    reprojection-based."""
    nb = mask.dim() - 1
    if sample_idx is None:
        sample_idx = _sample_minimal_sets(gen, mask, n_hyp, 6)
    idx = sample_idx.long()
    w6 = torch.ones(idx.shape, dtype=xy.dtype, device=xy.device)
    Rs, ts = pnp_dlt(take_rows(pts3d, idx, nb), take_rows(xy, idx, nb), w6)
    mask_f = mask.to(xy.dtype)
    depth, depth_h = {}, {}  # the depth terms, for one pose and for the hypotheses
    if z_meas is not None:
        zok = z_valid & mask
        w_z = zok.to(xy.dtype)
        depth = {"z_meas": z_meas, "w_z": w_z, "baseline": baseline}
        depth_h = {"z_meas": z_meas.unsqueeze(-2), "w_z": w_z.unsqueeze(-2), "baseline": baseline}
    # Each problem's points against all of its hypotheses: (..., 1, N, .).
    P, x, m = pts3d.unsqueeze(-3), xy.unsqueeze(-3), mask_f.unsqueeze(-2)
    Rs, ts = refine_pose_gn(Rs, ts, P, x, m, iters=2, huber=4.0 * thresh, **depth_h)
    errs = _reproj_err2(Rs, ts, P, x)  # (..., H, N)
    t2 = thresh * thresh
    cost = torch.where(mask.unsqueeze(-2), torch.clamp(errs, max=t2), 0.0).sum(-1)
    if depth:
        errs_z = _depth_err2(Rs, ts, P, z_meas.unsqueeze(-2), baseline)
        cost = cost + torch.where(zok.unsqueeze(-2), torch.clamp(errs_z, max=t2), 0.0).sum(-1)
    # gather, not indexing by the 0-d argmin: that reads it on the host.
    best = torch.argmin(cost, dim=-1)[..., None, None, None]
    R0 = Rs.gather(-3, best.expand(*best.shape[:-2], 3, 3))[..., 0, :, :]
    t0 = ts.gather(-2, best[..., 0].expand(*best.shape[:-3], 1, 3))[..., 0, :]
    inl0 = (_reproj_err2(R0, t0, pts3d, xy) < t2) & mask
    R, t = refine_pose_gn(R0, t0, pts3d, xy, inl0.to(xy.dtype), iters=refine_iters, huber=thresh, **depth)
    inliers = (_reproj_err2(R, t, pts3d, xy) < t2) & mask
    better = (inliers.sum(-1) >= inl0.sum(-1))[..., None]
    R = torch.where(better[..., None], R, R0)
    t = torch.where(better, t, t0)
    inliers = torch.where(better, inliers, inl0)
    n_inl = inliers.sum(-1)
    return {"R": R, "t": t, "T": make_T(R, t), "inliers": inliers, "n_inliers": n_inl, "ok": n_inl >= 6}


def ransac_pnp_depth(
    pts3d: torch.Tensor,
    xy: torch.Tensor,
    mask: torch.Tensor,
    z_meas: torch.Tensor,
    z_valid: torch.Tensor,
    baseline: float,
    gen=None,
    n_hyp: int = 256,
    thresh: torch.Tensor | float = 6e-3,
    refine_iters: int = 8,
    sample_idx: torch.Tensor | None = None,
) -> dict:
    """Fixed-budget RANSAC PnP with per-point depth measurements (stereo
    disparity, RGB-D depth): the hypotheses of ``ransac_pnp``, with the
    normalized-disparity residual in the local optimization, the scoring
    and the polish, so the winning pose agrees with the second modality as
    well as the reprojections. Arguments and outputs as ``ransac_pnp``,
    leading batch included."""
    return ransac_pnp(pts3d, xy, mask, gen, n_hyp=n_hyp, thresh=thresh, refine_iters=refine_iters,
                      sample_idx=sample_idx, z_meas=z_meas, z_valid=z_valid, baseline=baseline)
