"""Adam (first-order) bundle adjustment, the ``optimization.solver="adam"``
back end (port of ``visual_slam_tpu.backend.adam``).

Adam over landmark positions and per-pose (so(3) tangent around the
initial rotation, translation) parameters, Huber loss, the first keyframe
and the unused pose slots frozen through the ``free`` mask. Every step is
one evaluation of the dense (M, W) residual grid the LM solver uses
(``ba._residuals_and_jacobians``), its gradient by ``torch.autograd``, and
optax's ``adam(lr)`` update (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
written out as tensor operations in optax's order. The ``n_iter`` loop is
a Python loop, the counterpart of JAX's ``lax.scan``: on CUDA tensors it
reads nothing back to the host. No kernel of its own: the JAX package
computes it in XLA, with no ``pallas_call``.

``AdamOptimizer`` is an ``LMOptimizer`` whose ``_solve_and_writeback``
solves with Adam, as the JAX package's is: ``optimize_initial``,
``optimize_local`` and ``optimize_global`` reach Adam, while the ``*_start``
dispatches (``optimize_local_start``, ``optimize_global_start``, used by
``CompiledSLAM``'s asynchronous boundary) stay the LM/Schur solve.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.lie import so3_exp
from ..utils.tree import to_device, to_host
from .ba import BAProblem, _residuals_and_jacobians
from .optimizer import LMOptimizer, _next_pow2

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _huber(r2: torch.Tensor, delta: float) -> torch.Tensor:
    r = torch.sqrt(r2 + 1e-12)
    return torch.where(r <= delta, 0.5 * r2, delta * (r - 0.5 * delta))


def adam_bundle_adjust(
    problem: BAProblem, n_iter: int = 150, lr: float = 1e-3, huber: float = 5e-3
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Returns (T_w2c (W, 4, 4), points (M, 3), info) like ``bundle_adjust``:
    ``info["costs"]`` (n_iter,) holds the loss each step's gradient was taken
    at, ``cost0`` the loss before the first step and ``cost`` the last entry
    of ``costs`` (the loss before the last update), as JAX's scan returns
    them."""
    W = problem.n_poses
    dev = problem.points.device
    w_obs = problem.obs_valid.to(torch.float32)
    free = (problem.pose_valid & ~problem.pose_fixed).to(torch.float32)[:, None]
    R0 = problem.T_w2c[:, :3, :3]
    t0 = problem.T_w2c[:, :3, 3]
    params = [torch.zeros((W, 3), dtype=torch.float32, device=dev), t0.clone(), problem.points.clone()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]

    def poses_of(w, t):
        T = torch.eye(4, dtype=torch.float32, device=dev).repeat(W, 1, 1)
        T[:, :3, :3] = so3_exp(w * free) @ R0
        T[:, :3, 3] = t * free + t0 * (1.0 - free)
        return T

    def loss_fn(w, t, X):
        r, _, _, in_front = _residuals_and_jacobians(poses_of(w, t), X, problem.uv, w_obs > 0)
        r2 = torch.sum(r * r, dim=-1)
        return torch.sum(_huber(r2, huber) * w_obs * in_front)

    with torch.no_grad():
        cost0 = loss_fn(*params)
    costs = torch.empty((n_iter,), dtype=torch.float32, device=dev)
    for k in range(n_iter):
        for p in params:
            p.requires_grad_(True)
        loss = loss_fn(*params)
        grads = torch.autograd.grad(loss, params)
        costs[k] = loss.detach()
        # optax.scale_by_adam, then scale_by_learning_rate and apply_updates.
        bc1, bc2 = 1.0 - _B1 ** (k + 1), 1.0 - _B2 ** (k + 1)
        with torch.no_grad():
            for i, g in enumerate(grads):
                mu[i] = (1.0 - _B1) * g + _B1 * mu[i]
                nu[i] = (1.0 - _B2) * (g * g) + _B2 * nu[i]
                update = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + _ADAM_EPS)
                params[i] = params[i].detach() + (-lr) * update
    w, t, X = params
    with torch.no_grad():
        T = poses_of(w, t)
    return T, X, {"cost0": cost0, "cost": costs[-1], "costs": costs}


class AdamOptimizer(LMOptimizer):
    """The optimizer facade with the Adam solver (``optimization.solver ==
    "adam"``): the same point selection, bucket and dense pack as the JAX
    package's ``AdamOptimizer``, the Huber threshold in normalized
    coordinates, and the mono gauge re-imposed on the global BA."""

    def _solve_and_writeback(self, keyframes, map_points, w_bucket, fixed_flags=None, renormalize_scale=False):
        cfg = self.config.optimization
        if fixed_flags is None:
            fixed_flags = [j == 0 for j in range(len(keyframes))]
        map_points = self._select_points(map_points, cfg.max_points)
        m_bucket = min(_next_pow2(len(map_points)), cfg.max_points)
        problem, used_points, _, _, _ = self._pack(keyframes, map_points, w_bucket, m_bucket, fixed_flags)
        focal = float(self.camera.K[0, 0])
        T, X, info = adam_bundle_adjust(to_device(problem, self.device), n_iter=cfg.n_iter, lr=cfg.lr,
                                        huber=cfg.huber_delta / focal)
        T_np, X_np, cost0, cost = to_host((T, X, info["cost0"], info["cost"]))
        T_np = np.array(T_np)  # writable: the gauge re-projection mutates it
        X_np = np.array(X_np)
        gauge_transform = None
        if renormalize_scale and len(keyframes) >= 2:
            # Adam's global BA drifts along the mono scale null direction as LM's does.
            X_np, gauge_transform = self._reimpose_mono_gauge(T_np, X_np, keyframes, fixed_flags)
        for j, kf in enumerate(keyframes):
            if not kf.is_fixed and not fixed_flags[j]:
                kf.update_pose(T_np[j].astype(np.float64))
        for i, mp in enumerate(used_points):
            mp.update_position(X_np[i].astype(np.float64))
        return {
            "cost0": float(cost0),
            "cost": float(cost),
            "n_points": len(used_points),
            "n_keyframes": len(keyframes),
            "solver": "adam",
            "gauge_transform": gauge_transform,
        }
