"""Levenberg-Marquardt bundle adjustment with Schur-complement landmark
elimination, dense layout (port of the dense solver of
``visual_slam_tpu.backend.ba``).

All observations form a dense (M points x W poses) grid; every LM step is
fixed-shape linear algebra: residuals and analytic Jacobians over the grid,
Huber IRLS weights, normal-equation blocks (U per pose 6x6, V per point
3x3, Y per observation 6x3), the Schur complement S = U - Y V^-1 Y^T as a
(6W, 6W) Cholesky solve, landmark back-substitution with closed-form 3x3
inverses, and a gain test with adaptive damping. The iteration loop is a
Python loop of branch-free selects: nothing reads a value back to the host.

A Cholesky that fails (S not positive definite) marks the step NaN on the
device, as JAX's ``cholesky`` does by itself: its cost is then NaN, the step
is rejected and the damping grows. ``cholesky_ex`` alone would return a
partial factor whose solve is finite garbage that could be accepted.

Observations are in normalized image coordinates; thresholds in pixels are
divided by the focal length at the call site.

The sparse landmark-major layout (``BASparse``, ``bundle_adjust_sparse``,
``bundle_adjust_robust_sparse``) holds K observation slots per landmark,
each with its pose slot (``obs_pose``): residuals, Jacobians and the
landmark blocks cost O(M K) instead of O(M W). Pose blocks are gathered
with ``T_w2c[obs_pose]``. The pose-indexed sums (U, the gradient, the
Schur right-hand side) are one-hot products, (W, M K) x (M K, n): a
matmul adds in a fixed order, where ``index_add_`` on the card adds with
float atomics in an order that changes from run to run, and at (W, M, K) =
(64, 4096, 16) the product is 0.15 GFLOP. The Schur cross term scatters
each observation's block into its (landmark, pose) slot (one observation
per pair, so the scatter adds only exact zeros from empty slots) and
contracts the landmarks away in one (6W, 3M) x (3M, 6W) matmul, as the
dense solver does. The landmark-minor layout is not ported: it exists for
the TPU's (8, 128) tiling.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lie import make_T, so3_exp

_EPS = 1e-9


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment window: at most one observation
    per (landmark, keyframe) pair."""

    T_w2c: torch.Tensor  # (W, 4, 4) keyframe poses, world -> camera
    points: torch.Tensor  # (M, 3) landmark positions (world)
    uv: torch.Tensor  # (M, W, 2) normalized observations
    obs_valid: torch.Tensor  # (M, W) bool
    pose_valid: torch.Tensor  # (W,) bool: slot in use
    pose_fixed: torch.Tensor  # (W,) bool: gauge-frozen

    @property
    def n_poses(self) -> int:
        return self.T_w2c.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def _residuals_and_jacobians(T_w2c, points, uv, w):
    """Residuals r (M, W, 2), pose Jacobians Jp (M, W, 2, 6) for the left
    se(3) perturbation, point Jacobians Jx (M, W, 2, 3), and the in-front
    mask (M, W)."""
    R = T_w2c[:, :3, :3]
    t = T_w2c[:, :3, 3]
    pc = torch.einsum("wab,mb->mwa", R, points) + t[None]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / zs
    u = x * inv_z
    v = y * inv_z
    r = torch.stack([u, v], dim=-1) - uv
    zero = torch.zeros_like(u)
    Ju = torch.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], dim=-1)
    Jv = torch.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], dim=-1)
    Jp = torch.stack([Ju, Jv], dim=-2)
    A = torch.stack(
        [torch.stack([inv_z, zero, -u * inv_z], dim=-1), torch.stack([zero, inv_z, -v * inv_z], dim=-1)],
        dim=-2,
    )
    Jx = torch.einsum("mwab,wbc->mwac", A, R)
    return r, Jp, Jx, z > _EPS


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of batched 3x3 matrices (..., 3, 3); the
    damped V blocks are symmetric positive definite."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, _EPS, det)
    adj = torch.stack(
        [torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1), torch.stack([c20, c21, c22], -1)],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _robust_weights(r: torch.Tensor, huber) -> torch.Tensor:
    """Huber IRLS weights from residual norms (M, W)."""
    rn = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(rn <= huber, 1.0, huber / torch.clamp(rn, min=_EPS))


def _cost(r, w_obs, in_front, huber) -> torch.Tensor:
    """Total robust (Huber) cost. Behind-camera observations pay a large
    fixed penalty instead of zero: with them merely masked out, pushing
    every landmark behind the cameras is a global minimum of cost 0, which
    f32 LM paths do find on weak-parallax windows."""
    rn2 = torch.sum(r * r, dim=-1)
    rn = torch.sqrt(rn2 + _EPS)
    rho = torch.where(rn <= huber, 0.5 * rn2, huber * (rn - 0.5 * huber))
    pen = 20.0 * huber
    return torch.sum(torch.where(in_front, rho, pen) * w_obs)


def _block_diag_add(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (W, 6, W, 6) plus ``blocks`` (W, 6, 6) on its diagonal pose blocks:
    JAX's ``S.at[arange(W), :, arange(W), :].add(blocks)``, whose advanced
    indices put the W axis first."""
    W = S.shape[0]
    idx = torch.arange(W, device=S.device)
    out = S.clone()
    out[idx, :, idx, :] += blocks
    return out


def _damp(U, V, lam):
    U = U + lam * torch.eye(6, dtype=U.dtype, device=U.device)
    V = V + lam * torch.eye(3, dtype=V.dtype, device=V.device)
    return U, _inv3x3(V)


def _pose_step(U, S_cross, b, pose_free):
    """Solve the reduced pose system (U - S_cross) dxi = -b: fixed or unused
    pose slots get identity rows and columns and a zero right-hand side;
    dxi is NaN when the Cholesky fails."""
    W = U.shape[0]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    S = _block_diag_add(-S_cross, U)
    free = pose_free
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = _block_diag_add(S, eye6 * (1.0 - free)[:, None, None])
    b = b * free[:, None]
    # cholesky_ex and the two triangular solves read no status back to the
    # host (linalg.cholesky and cholesky_solve may).
    L, info = torch.linalg.cholesky_ex(S.reshape(W * 6, W * 6))
    y = torch.linalg.solve_triangular(L, b.reshape(W * 6, 1), upper=False)
    dxi = -torch.linalg.solve_triangular(L.T, y, upper=True).reshape(W, 6)
    return torch.where(info == 0, dxi, torch.nan)


def _cross(Tb, Yd):
    """S_cross[u, i, v, j] = sum_m,k Tb[m, u, i, k] Yd[m, v, j, k] for dense
    (M, W, 6, 3) blocks: one GEMM."""
    M, W = Tb.shape[:2]
    Tm = Tb.permute(1, 2, 0, 3).reshape(W * 6, M * 3)
    Ym = Yd.permute(1, 2, 0, 3).reshape(W * 6, M * 3)
    return (Tm @ Ym.T).reshape(W, 6, W, 6)


def _solve_step(T_w2c, points, uv, w_obs, pose_free, lam, huber):
    """One LM linear solve: (dxi (W, 6), dX (M, 3)). dxi and dX are NaN when
    the Schur system's Cholesky fails."""
    r, Jp, Jx, in_front = _residuals_and_jacobians(T_w2c, points, uv, w_obs > 0)
    w = w_obs * _robust_weights(r, huber) * in_front
    Jp = Jp * pose_free[None, :, None, None]
    Jpw = Jp * w[..., None, None]
    Jxw = Jx * w[..., None, None]

    U = torch.einsum("mwai,mwaj->wij", Jpw, Jp)
    V = torch.einsum("mwai,mwaj->mij", Jxw, Jx)
    gp = torch.einsum("mwai,mwa->wi", Jpw, r)
    gx = torch.einsum("mwai,mwa->mi", Jxw, r)
    Y = Jpw[:, :, 0, :, None] * Jx[:, :, 0, None, :] + Jpw[:, :, 1, :, None] * Jx[:, :, 1, None, :]  # (M, W, 6, 3)

    U, Vinv = _damp(U, V, lam)
    T_blk = Y @ Vinv[:, None]  # (M, W, 6, 3)
    dxi = _pose_step(U, _cross(T_blk, Y), gp - torch.einsum("mwik,mk->wi", T_blk, gx), pose_free)
    g2 = gx + torch.einsum("mwij,wi->mj", Y, dxi)
    dX = -(Vinv @ g2[..., None])[..., 0]
    return dxi, dX


def _apply_step(T_w2c, points, dxi, dX):
    dR = so3_exp(dxi[:, 3:])
    R_new = dR @ T_w2c[:, :3, :3]
    t_new = torch.einsum("wij,wj->wi", dR, T_w2c[:, :3, 3]) + dxi[:, :3]
    return make_T(R_new, t_new), points + dX


def _lm(T, X, cost_of, solve_step, n_iter: int, lam0: float):
    """The damped LM loop over ``solve_step(T, X, lam) -> (dxi, dX)``.
    Accept/reject are selects: lambda halves on improvement and grows x4 on
    a rejected step, clipped to [1e-9, 1e6]."""
    c0 = cost_of(T, X)
    c = c0
    lam = torch.full((), lam0, dtype=torch.float32, device=T.device)
    costs = []
    for _ in range(n_iter):
        dxi, dX = solve_step(T, X, lam)
        T_new, X_new = _apply_step(T, X, dxi, dX)
        c_new = cost_of(T_new, X_new)
        accept = c_new < c
        T = torch.where(accept, T_new, T)
        X = torch.where(accept, X_new, X)
        c = torch.where(accept, c_new, c)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        costs.append(c)
    info = {"cost0": c0, "cost": c, "costs": torch.stack(costs) if costs else c0[None], "lambda": lam}
    return T, X, info


def bundle_adjust(problem: BAProblem, n_iter: int = 20, huber: float = 5e-3, lam0: float = 1e-3):
    """The damped LM loop: (T_w2c', points', info). ``huber`` is in
    normalized units. info: cost0, cost, costs (n_iter,), lambda, all device
    tensors."""
    w_obs = problem.obs_valid.to(torch.float32)
    pose_free = (problem.pose_valid & ~problem.pose_fixed).to(torch.float32)

    def cost_of(T, X):
        r, _, _, in_front = _residuals_and_jacobians(T, X, problem.uv, w_obs > 0)
        return _cost(r, w_obs, in_front, huber)

    def step(T, X, lam):
        return _solve_step(T, X, problem.uv, w_obs, pose_free, lam, huber)

    return _lm(problem.T_w2c, problem.points, cost_of, step, n_iter, lam0)


def residual_norms(T_w2c, points, uv, obs_valid) -> torch.Tensor:
    """Per-observation reprojection error norms (M, W) in normalized
    coordinates; invalid or behind-camera observations get +inf."""
    r, _, _, in_front = _residuals_and_jacobians(T_w2c, points, uv, obs_valid)
    rn = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(obs_valid & in_front, rn, torch.inf)


def _two_stage(problem, solve, norms, n_iter, n_iter2, huber, lam0, trim_factor):
    """Robust solve, drop the observations whose ``norms(T, X)`` exceed
    ``trim_factor * huber``, re-solve on the kept set."""
    T, X, info1 = solve(problem, n_iter=n_iter, huber=huber, lam0=lam0)
    kept = problem.obs_valid & (norms(T, X) < trim_factor * huber)
    T, X, info2 = solve(problem._replace(T_w2c=T, points=X, obs_valid=kept), n_iter=n_iter2, huber=huber,
                        lam0=lam0)
    info = {
        "cost0": info1["cost0"],
        "cost": info2["cost"],
        "obs_kept": kept,
        "n_trimmed": problem.obs_valid.sum() - kept.sum(),
    }
    return T, X, info


def bundle_adjust_robust(
    problem: BAProblem,
    n_iter: int = 10,
    n_iter2: int = 10,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    trim_factor: float = 3.0,
):
    """Two-stage BA with interim outlier gating: robust solve, drop the
    observations with residual above ``trim_factor * huber``, re-solve on
    the kept set. info: cost0, cost, obs_kept (M, W), n_trimmed."""
    return _two_stage(problem, bundle_adjust, lambda T, X: residual_norms(T, X, problem.uv, problem.obs_valid),
                      n_iter, n_iter2, huber, lam0, trim_factor)


# ---------------------------------------------------------------- sparse
class BASparse(NamedTuple):
    """Fixed-capacity landmark-major window: K observation slots per
    landmark, ``obs_pose`` the pose slot of each (0 where the slot is
    empty: its weight is zero)."""

    T_w2c: torch.Tensor  # (W, 4, 4) keyframe poses, world -> camera
    points: torch.Tensor  # (M, 3) landmark positions (world)
    uv: torch.Tensor  # (M, K, 2) normalized observations
    obs_pose: torch.Tensor  # (M, K) int pose slot of each observation
    obs_valid: torch.Tensor  # (M, K) bool
    pose_valid: torch.Tensor  # (W,) bool
    pose_fixed: torch.Tensor  # (W,) bool

    @property
    def n_poses(self) -> int:
        return self.T_w2c.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def _residuals_and_jacobians_sparse(T_w2c, points, uv, obs_pose):
    """:func:`_residuals_and_jacobians` over the (M, K) observation slots,
    each against its pose ``T_w2c[obs_pose]``."""
    Rg = T_w2c[:, :3, :3][obs_pose]  # (M, K, 3, 3)
    pc = torch.einsum("mkab,mb->mka", Rg, points) + T_w2c[:, :3, 3][obs_pose]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / zs
    u = x * inv_z
    v = y * inv_z
    r = torch.stack([u, v], dim=-1) - uv
    zero = torch.zeros_like(u)
    Ju = torch.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], dim=-1)
    Jv = torch.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], dim=-1)
    Jp = torch.stack([Ju, Jv], dim=-2)
    A = torch.stack(
        [torch.stack([inv_z, zero, -u * inv_z], dim=-1), torch.stack([zero, inv_z, -v * inv_z], dim=-1)],
        dim=-2,
    )
    return r, Jp, A @ Rg, z > _EPS


def _solve_step_sparse(T_w2c, points, uv, obs_pose, onehot, w_obs, pose_free, lam, huber):
    """One LM linear solve on the sparse layout: (dxi (W, 6), dX (M, 3)).
    ``onehot`` (M K, W) is ``obs_pose``'s indicator, built once a solve."""
    M, K = uv.shape[:2]
    W = T_w2c.shape[0]
    r, Jp, Jx, in_front = _residuals_and_jacobians_sparse(T_w2c, points, uv, obs_pose)
    w = w_obs * _robust_weights(r, huber) * in_front
    Jp = Jp * pose_free[obs_pose][..., None, None]
    Jpw = Jp * w[..., None, None]
    Jxw = Jx * w[..., None, None]

    def pose_sum(x):  # (M, K, ...) -> (W, ...): sum of each observation's block at its pose
        return (onehot.T @ x.reshape(M * K, -1)).reshape(W, *x.shape[2:])

    U = pose_sum(torch.einsum("mkai,mkaj->mkij", Jpw, Jp))
    gp = pose_sum(torch.einsum("mkai,mka->mki", Jpw, r))
    V = torch.einsum("mkai,mkaj->mij", Jxw, Jx)
    gx = torch.einsum("mkai,mka->mi", Jxw, r)
    Y = Jpw[:, :, 0, :, None] * Jx[:, :, 0, None, :] + Jpw[:, :, 1, :, None] * Jx[:, :, 1, None, :]  # (M, K, 6, 3)

    U, Vinv = _damp(U, V, lam)
    T_blk = Y @ Vinv[:, None]  # (M, K, 6, 3)
    # Each block into its (landmark, pose) slot; empty slots add exact zeros.
    m_idx = torch.arange(M, device=uv.device)[:, None].expand(M, K)

    def dense(x):
        return torch.zeros((M, W, 6, 3), dtype=x.dtype, device=x.device).index_put_((m_idx, obs_pose), x,
                                                                                     accumulate=True)

    b = gp - pose_sum(torch.einsum("mkil,ml->mki", T_blk, gx))
    dxi = _pose_step(U, _cross(dense(T_blk), dense(Y)), b, pose_free)
    g2 = gx + torch.einsum("mkij,mki->mj", Y, dxi[obs_pose])
    dX = -(Vinv @ g2[..., None])[..., 0]
    return dxi, dX


def bundle_adjust_sparse(problem: BASparse, n_iter: int = 20, huber: float = 5e-3, lam0: float = 1e-3):
    """:func:`bundle_adjust` on the sparse layout: the same LM loop, costs
    and info."""
    w_obs = problem.obs_valid.to(torch.float32)
    pose_free = (problem.pose_valid & ~problem.pose_fixed).to(torch.float32)
    obs_pose = problem.obs_pose.long()
    onehot = torch.nn.functional.one_hot(obs_pose.reshape(-1), problem.T_w2c.shape[0]).to(torch.float32)

    def cost_of(T, X):
        r, _, _, in_front = _residuals_and_jacobians_sparse(T, X, problem.uv, obs_pose)
        return _cost(r, w_obs, in_front, huber)

    def step(T, X, lam):
        return _solve_step_sparse(T, X, problem.uv, obs_pose, onehot, w_obs, pose_free, lam, huber)

    return _lm(problem.T_w2c, problem.points, cost_of, step, n_iter, lam0)


def residual_norms_sparse(T_w2c, points, uv, obs_pose, obs_valid) -> torch.Tensor:
    """Per-observation reprojection error norms (M, K); invalid or
    behind-camera observations get +inf."""
    r, _, _, in_front = _residuals_and_jacobians_sparse(T_w2c, points, uv, obs_pose.long())
    rn = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(obs_valid & in_front, rn, torch.inf)


def bundle_adjust_robust_sparse(
    problem: BASparse,
    n_iter: int = 10,
    n_iter2: int = 10,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    trim_factor: float = 3.0,
):
    """:func:`bundle_adjust_robust` on the sparse layout; info['obs_kept']
    is (M, K)."""
    return _two_stage(
        problem, bundle_adjust_sparse,
        lambda T, X: residual_norms_sparse(T, X, problem.uv, problem.obs_pose, problem.obs_valid),
        n_iter, n_iter2, huber, lam0, trim_factor,
    )


def mean_reprojection_error(T_w2c, points, uv, obs_valid, focal: float = 1.0) -> torch.Tensor:
    """Masked mean reprojection error over the window, in pixels when
    ``focal`` is the focal length."""
    r, _, _, in_front = _residuals_and_jacobians(T_w2c, points, uv, obs_valid)
    rn = torch.linalg.vector_norm(r, dim=-1) * focal
    w = obs_valid & in_front
    return torch.where(w, rn, 0.0).sum() / torch.clamp(w.sum(), min=1)
