"""Trajectory evaluation: ATE / RPE with Umeyama similarity alignment
(port of ``visual_slam_tpu.utils.metrics``, unchanged: it is pure numpy).

Monocular trajectories are compared after Sim(3) alignment: scale is a
gauge freedom of the estimator, not an error.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform dst ~ s * R @ src + t.

    Args: src/dst (N, 3). Returns (s, R (3,3), t (3,)).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    traj_est: np.ndarray, traj_gt: np.ndarray, align_scale: bool = True
) -> dict:
    """Absolute trajectory error after similarity alignment.

    Args: (N, 3) camera centers, index-aligned. Returns dict with rmse/mean/
    median/max and the alignment (s, R, t).
    """
    s, R, t = umeyama_alignment(traj_est, traj_gt, with_scale=align_scale)
    aligned = traj_est @ (s * R).T + t
    err = np.linalg.norm(aligned - traj_gt, axis=-1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "scale": s,
        "R": R,
        "t": t,
        "aligned": aligned,
    }


def rpe(
    poses_est: np.ndarray, poses_gt: np.ndarray, delta: int = 1
) -> dict:
    """Relative pose error over a fixed frame delta.

    Args: (N, 4, 4) T_w2c arrays, index-aligned.
    Returns translational / rotational RMSE of the relative motions.
    """
    t_errs, r_errs = [], []
    for i in range(len(poses_est) - delta):
        d_est = poses_est[i + delta] @ np.linalg.inv(poses_est[i])
        d_gt = poses_gt[i + delta] @ np.linalg.inv(poses_gt[i])
        e = np.linalg.inv(d_gt) @ d_est
        t_errs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(c))
    t_errs = np.asarray(t_errs)
    r_errs = np.asarray(r_errs)
    return {
        "trans_rmse": float(np.sqrt((t_errs**2).mean())) if len(t_errs) else 0.0,
        "rot_rmse_deg": float(np.rad2deg(np.sqrt((r_errs**2).mean()))) if len(r_errs) else 0.0,
    }


def trajectory_from_keyframes(keyframes) -> np.ndarray:
    """(N, 3) camera centers from KeyFrame list."""
    return np.stack([kf.t_c2w for kf in keyframes])
