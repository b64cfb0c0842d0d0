"""Pose-graph optimization over SE(3) and Sim(3)
(port of ``visual_slam_tpu.loop_closing.pose_graph``).

Fixed-shape Gauss-Newton: N pose slots and E edge slots (padded and
masked); the residual per edge is a log-map of the edge's mismatch, its
Jacobian (6E x 6N, or 7E x 7N) comes from ``torch.func.jacfwd`` of the same
residual function at a zero tangent update, as JAX's ``jax.jacfwd`` does,
and the damped normal equations are solved with ``linalg.solve_ex``, which
reads no error status back to the host. The fixed iteration count is a
Python loop; the costs stay on the device until the caller reads them.

The builders take numpy poses (host bookkeeping) and return the graph as
tensors on ``device``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from ..ops.lie import inv_T, se3_exp, se3_log, so3_exp, so3_log


class PoseGraph(NamedTuple):
    T_w2c: torch.Tensor  # (N, 4, 4) node poses
    node_valid: torch.Tensor  # (N,) bool
    node_fixed: torch.Tensor  # (N,) bool (gauge anchors)
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    T_meas: torch.Tensor  # (E, 4, 4) measured T_i_w2c @ inv(T_j_w2c)
    edge_weight: torch.Tensor  # (E,) float32 (0 = padding)


def _edge_residuals(xi: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E*6,) stacked residuals for the tangent update xi (N, 6):
    T_n <- exp(xi_n) T_n."""
    T = se3_exp(xi) @ graph.T_w2c  # (N, 4, 4)
    rel = T[graph.edge_i] @ inv_T(T[graph.edge_j])
    err = se3_log(inv_T(graph.T_meas) @ rel)  # (E, 6)
    return (err * graph.edge_weight[:, None]).reshape(-1)


def _gauss_newton(residuals, state, n_params: int, free: torch.Tensor, lam: float, n_iter: int, apply):
    """Shared Gauss-Newton loop: ``residuals(p, state)`` for a flat tangent
    update ``p`` of N * n_params, ``apply(state, dp (N, n_params))`` the
    update. Returns (state, costs (n_iter,))."""
    N = free.shape[0]
    mask = free.repeat_interleave(n_params)
    damp = lam * torch.eye(N * n_params, dtype=torch.float32, device=free.device) + torch.diag(1.0 - mask)
    p0 = torch.zeros(N * n_params, dtype=torch.float32, device=free.device)
    costs = []
    for _ in range(n_iter):
        r = residuals(p0, state)
        J = jacfwd(lambda p, s=state: residuals(p, s))(p0) * mask[None, :]
        H = J.T @ J + damp  # fixed and invalid parameters pinned
        dp, _ = torch.linalg.solve_ex(H, (J.T @ r)[:, None])
        state = apply(state, (-dp[:, 0] * mask).reshape(N, n_params))
        costs.append(torch.sum(r * r))
    return state, torch.stack(costs)


def optimize_pose_graph(graph: PoseGraph, n_iter: int = 10, lam: float = 1e-6) -> tuple[torch.Tensor, dict]:
    """Gauss-Newton with forward-mode Jacobians. Returns (T_w2c', info) with
    ``info["costs"]`` (n_iter,) and ``info["cost"]`` the last, as tensors."""
    free = (graph.node_valid & ~graph.node_fixed).to(torch.float32)

    def residuals(xi, g):
        return _edge_residuals(xi.reshape(-1, 6), g)

    def apply(g, dxi):
        return g._replace(T_w2c=se3_exp(dxi) @ g.T_w2c)

    g, costs = _gauss_newton(residuals, graph, 6, free, lam, n_iter, apply)
    return g.T_w2c, {"costs": costs, "cost": costs[-1]}


class Sim3Graph(NamedTuple):
    """Pose graph over Sim(3), the ORB-SLAM essential-graph formulation.
    Node n is the similarity (R_n, t_n, s_n) mapping world to camera,
    x_c = s_n R_n x_w + t_n; each edge measures the relative similarity
    S_i S_j^-1 = (R_i R_j^T, t_i - (s_i/s_j) R_i R_j^T t_j, s_i/s_j). Mono
    loop closures correct scale drift as well as pose."""

    T_w2c: torch.Tensor  # (N, 4, 4) rotation R_n and Sim(3) translation t_n
    log_s: torch.Tensor  # (N,) log scale per node (init 0)
    node_valid: torch.Tensor
    node_fixed: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    T_meas: torch.Tensor  # (E, 4, 4) measured relative (R_meas, t_meas)
    s_meas: torch.Tensor  # (E,) measured relative scale s_i / s_j
    edge_weight: torch.Tensor


def _sim3_edge_residuals(params: torch.Tensor, graph: Sim3Graph) -> torch.Tensor:
    """params (N, 7): [phi(3), dt(3), dsigma(1)] tangent update per node:
    R <- exp(phi) R, t <- t + dt, s <- s exp(dsigma). Edge residual (7-dof):
    [so3_log(R_meas^T R_rel), (t_rel - t_meas) / max(|t_meas|, 0.1),
    log(s_rel / s_meas)] with t_rel = t_i - s_rel R_rel t_j. Dividing by the
    measured baseline keeps the translation terms commensurate with the
    rotation and scale terms."""
    R = so3_exp(params[:, :3]) @ graph.T_w2c[:, :3, :3]
    t = graph.T_w2c[:, :3, 3] + params[:, 3:6]
    log_s = graph.log_s + params[:, 6]
    Ri, Rj = R[graph.edge_i], R[graph.edge_j]
    ti, tj = t[graph.edge_i], t[graph.edge_j]
    s_rel = torch.exp(log_s[graph.edge_i] - log_s[graph.edge_j])
    R_rel = Ri @ Rj.transpose(-1, -2)
    t_rel = ti - s_rel[:, None] * torch.einsum("eab,eb->ea", R_rel, tj)
    R_meas = graph.T_meas[:, :3, :3]
    t_meas = graph.T_meas[:, :3, 3]
    err_R = so3_log(R_meas.transpose(-1, -2) @ R_rel)  # (E, 3)
    t_norm = torch.clamp(torch.linalg.vector_norm(t_meas, dim=-1, keepdim=True), min=0.1)
    err_t = (t_rel - t_meas) / t_norm
    err_s = (log_s[graph.edge_i] - log_s[graph.edge_j] - torch.log(graph.s_meas))[:, None]
    err = torch.cat([err_R, err_t, err_s], dim=-1)
    return (err * graph.edge_weight[:, None]).reshape(-1)


def optimize_sim3_graph(
    graph: Sim3Graph, n_iter: int = 10, lam: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Gauss-Newton over Sim(3) nodes. Returns (T_w2c', scales', info):
    T_w2c' are the corrected SE(3) poses (the Sim(3) translation divided by
    the node scale, ORB-SLAM's CorrectLoop recipe) and scales' the node
    scales: a landmark anchored at keyframe r maps to
    X_new = T_w2c'[r]^-1 ((T_old[r] X_old) / scales'[r])."""
    free = (graph.node_valid & ~graph.node_fixed).to(torch.float32)

    def residuals(p, g):
        return _sim3_edge_residuals(p.reshape(-1, 7), g)

    def apply(g, dp):
        T = g.T_w2c.clone()
        T[:, :3, :3] = so3_exp(dp[:, :3]) @ g.T_w2c[:, :3, :3]
        T[:, :3, 3] = g.T_w2c[:, :3, 3] + dp[:, 3:6]
        return g._replace(T_w2c=T, log_s=g.log_s + dp[:, 6])

    g, costs = _gauss_newton(residuals, graph, 7, free, lam, n_iter, apply)
    scales = torch.exp(g.log_s)
    T_se3 = g.T_w2c.clone()
    T_se3[:, :3, 3] = g.T_w2c[:, :3, 3] / scales[:, None]
    return T_se3, scales, {"costs": costs, "cost": costs[-1]}


def _tensors(device, **arrays) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def build_sim3_graph(
    poses,
    loop_edges: list[tuple[int, int, np.ndarray, float]] | None = None,
    covis_edges: list[tuple[int, int, float]] | None = None,
    loop_weight: float = 15.0,
    device=None,
) -> Sim3Graph:
    """Essential graph: the odometry chain and covisibility edges (measured
    from the current poses at relative scale 1) plus loop edges with an
    externally measured relative pose and scale.

    Args:
      loop_edges: [(i, j, T_meas, s_meas), ...]: T_meas = T_i_corrected @
        inv(T_j) from geometric verification; s_meas the local map scale at
        node i relative to node j. Its translation is scaled by s_meas into
        the Sim(3) convention (node translations are s times the SE(3) one).
      covis_edges: [(i, j, weight), ...], measured from the current poses.
    """
    poses = np.asarray(poses)
    N = len(poses)
    loop_edges = loop_edges or []
    covis_edges = covis_edges or []
    E = (N - 1) + len(covis_edges) + len(loop_edges)
    ei = np.zeros(E, np.int64)
    ej = np.zeros(E, np.int64)
    Tm = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    sm = np.ones(E, np.float32)
    w = np.zeros(E, np.float32)
    for k in range(N - 1):
        ei[k], ej[k] = k, k + 1
        Tm[k] = poses[k] @ np.linalg.inv(poses[k + 1])
        w[k] = 1.0
    for idx, (i, j, weight) in enumerate(covis_edges):
        k = (N - 1) + idx
        ei[k], ej[k] = i, j
        Tm[k] = poses[i] @ np.linalg.inv(poses[j])
        w[k] = weight
    for idx, (i, j, T_meas, s_meas) in enumerate(loop_edges):
        k = (N - 1) + len(covis_edges) + idx
        ei[k], ej[k] = i, j
        Tm[k] = np.asarray(T_meas)
        Tm[k][:3, 3] *= s_meas
        sm[k] = s_meas
        w[k] = loop_weight
    node_fixed = np.zeros(N, bool)
    node_fixed[0] = True
    return Sim3Graph(**_tensors(
        device,
        T_w2c=poses.astype(np.float32),
        log_s=np.zeros(N, np.float32),
        node_valid=np.ones(N, bool),
        node_fixed=node_fixed,
        edge_i=ei,
        edge_j=ej,
        T_meas=Tm,
        s_meas=sm,
        edge_weight=w,
    ))


def build_sequential_graph(
    poses,
    loop_edges: list[tuple] | None = None,
    n_slots: int | None = None,
    e_slots: int | None = None,
    loop_weight: float = 5.0,
    device=None,
) -> PoseGraph:
    """Odometry chain plus optional loop-closure edges.

    Args:
      poses: (N, 4, 4) current T_w2c estimates (consecutive pairs give the
        odometry measurements).
      loop_edges: [(i, j, T_meas), ...] or [(i, j, T_meas, weight), ...]:
        T_meas = T_i @ inv(T_j) as re-estimated by loop verification; a
        3-tuple gets ``loop_weight``.
    """
    poses = np.asarray(poses)
    N = len(poses)
    loop_edges = loop_edges or []
    n_slots = n_slots or N
    e_slots = e_slots or (N - 1) + len(loop_edges)

    T = np.tile(np.eye(4, dtype=np.float32), (n_slots, 1, 1))
    T[:N] = poses
    node_valid = np.zeros(n_slots, bool)
    node_valid[:N] = True
    node_fixed = np.zeros(n_slots, bool)
    node_fixed[0] = True
    ei = np.zeros(e_slots, np.int64)
    ej = np.zeros(e_slots, np.int64)
    Tm = np.tile(np.eye(4, dtype=np.float32), (e_slots, 1, 1))
    w = np.zeros(e_slots, np.float32)
    for k in range(N - 1):
        ei[k], ej[k] = k, k + 1
        Tm[k] = poses[k] @ np.linalg.inv(poses[k + 1])
        w[k] = 1.0
    for idx, edge in enumerate(loop_edges):
        i, j, T_meas = edge[0], edge[1], edge[2]
        k = (N - 1) + idx
        ei[k], ej[k] = i, j
        Tm[k] = np.asarray(T_meas)
        w[k] = edge[3] if len(edge) > 3 else loop_weight
    return PoseGraph(**_tensors(
        device, T_w2c=T, node_valid=node_valid, node_fixed=node_fixed,
        edge_i=ei, edge_j=ej, T_meas=Tm, edge_weight=w,
    ))
