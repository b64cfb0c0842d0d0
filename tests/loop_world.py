"""A drifted keyframe map around a ring world, for loop-closing tests and
``chip_smoke.py``: numpy only, generic over the map classes, so the same
map is built with the JAX package's classes or the port's.

The camera drives ``render.loop_path`` around ``render.make_ring_world``
and keeps every ``every``-th frame as a keyframe. Each keyframe gets a
monocular-drift pose: its camera center integrates the true steps scaled
by a factor growing linearly from 1 to ``scale_end`` and turned by a yaw
offset growing to ``yaw_end``, its rotation carries the same yaw offset.
Its landmarks are its keypoints' z-buffer depths, scaled by the local drift
factor and mapped out through the drifted pose, so each keyframe's local
structure is consistent with its drifted neighbours. Where a keypoint
matches one of the previous keyframe's (``links``), it observes that
keyframe's landmark instead of minting its own, so landmarks span
consecutive keyframes and covisibility edges exist.
"""
from __future__ import annotations

import numpy as np

from render import loop_path, make_ring_world, render_with_depth


def ring_keyframes(n_frames=200, every=4, width=1240, height=376, f=718.856, n_sprites=2400,
                   step=0.25, closes=1.06, seed=11):
    """Renders the keyframe frames of the ring sequence. Returns (K (3, 3),
    T_gt (N, 4, 4) true T_w2c, images (N, H, W) f32, depths (N, H, W))."""
    rng = np.random.default_rng(seed)
    Ts = loop_path(n_frames, step=step, closes=closes)[::every]
    yaw_rate = 2 * np.pi * closes / n_frames
    radius = step / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0,
                            n_sprites=n_sprites, y_range=(-6, 6))
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    images, depths = zip(*[render_with_depth(world, T, K, width, height) for T in Ts])
    return K, Ts, np.stack(images).astype(np.float32), np.stack(depths)


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def drift(T_gt, scale_end=1.3, yaw_end=0.06):
    """Drifted T_w2c (N, 4, 4) and the local drift factor per keyframe (N,)."""
    N = len(T_gt)
    s = 1.0 + (scale_end - 1.0) * np.arange(N) / max(N - 1, 1)
    psi = yaw_end * np.arange(N) / max(N - 1, 1)
    C = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_gt])
    C_d = C.copy()
    for k in range(N - 1):
        C_d[k + 1] = C_d[k] + s[k] * _yaw(psi[k]) @ (C[k + 1] - C[k])
    T_d = np.tile(np.eye(4), (N, 1, 1))
    for k in range(N):
        R = T_gt[k, :3, :3] @ _yaw(psi[k]).T
        T_d[k, :3, :3] = R
        T_d[k, :3, 3] = -R @ C_d[k]
    return T_d, s


def landmarks(xy, valid, depth, K, T_d, s, min_depth=0.5):
    """Per keypoint slot the drifted world landmark (K, 3) and whether the
    z-buffer has a sprite there (K,)."""
    H, W = depth.shape
    u = np.round(xy[:, 0]).astype(int)
    v = np.round(xy[:, 1]).astype(int)
    inside = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    z = np.where(inside, depth[np.clip(v, 0, H - 1), np.clip(u, 0, W - 1)], 0.0)
    has = inside & (z > min_depth)
    rays = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ np.linalg.inv(K).T
    x_cam = rays * (s * z)[:, None]
    X = (x_cam - T_d[:3, 3]) @ T_d[:3, :3]  # R^T (x - t)
    return X, has


def add_keyframe(classes, slam_map, kf, X, has, prev=None, link=None):
    """Adds ``kf`` to ``slam_map`` with landmarks: where ``link``
    (train_idx (K,), valid (K,)) matches slot i to a slot of ``prev`` that
    holds a landmark, slot i observes it; other slots with depth mint a new
    landmark at ``X[i]``. ``classes`` provides ``MapPoint``."""
    slam_map.add_keyframe(kf)
    for i in np.nonzero(has)[0]:
        mp = None
        if prev is not None and link is not None and link[1][i]:
            mp = prev.get_map_point(0, int(link[0][i]))
        if mp is None:
            mp = classes.MapPoint(X[i])
            slam_map.add_map_point(mp)
        kf.add_map_point(0, int(i), mp)


def keyframe_ate(T_w2c, T_gt) -> float:
    """Scale-aligned RMSE of the keyframe camera centers."""
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    C = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_w2c])
    G = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_gt])
    return ate_rmse(C, G, align_scale=True)["rmse"]


def bench_pose_graph_problem(n_nodes=256, n_loops=8, seed=3):
    """``bench.bench_pose_graph``'s problem (bench.py:831-844) without its
    imports: an odometry chain along x with drift and ``n_loops`` loop
    edges carrying the true relative pose. Returns (poses (N, 4, 4) f32,
    loops [(i, j, T_meas)])."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    for i in range(n_nodes):
        poses[i, 0, 3] = -0.5 * i - (0.02 * i * rng.uniform(0.5, 1.0))
    loops = []
    for _ in range(n_loops):
        i = int(rng.integers(n_nodes // 2, n_nodes - 1))
        j = int(rng.integers(0, n_nodes // 4))
        T_i = np.eye(4, dtype=np.float32)
        T_i[0, 3] = -0.5 * i
        T_j = np.eye(4, dtype=np.float32)
        T_j[0, 3] = -0.5 * j
        loops.append((i, j, T_i @ np.linalg.inv(T_j)))
    return poses, loops


def sim3_loop_problem(n_nodes=256, n_loops=8, seed=3, step=0.25):
    """A Sim(3) pose graph of ``n_nodes`` keyframes once around a circle
    (``render.loop_path``) with the drift of ``drift`` and ``n_loops`` loop
    edges from the last eighth of the loop to the first, each carrying the
    true relative pose and the relative drift factor. Returns (poses
    (N, 4, 4) f32, loops [(i, j, T_meas, s_meas)], true T_w2c (N, 4, 4))."""
    gt = loop_path(n_nodes, step=step, closes=1.0)
    T_d, s = drift(gt)
    rng = np.random.default_rng(seed)
    loops = []
    for _ in range(n_loops):
        i = int(rng.integers(n_nodes - n_nodes // 8, n_nodes))
        j = int(rng.integers(0, n_nodes // 8))
        loops.append((i, j, gt[i] @ np.linalg.inv(gt[j]), float(s[i] / s[j])))
    return T_d.astype(np.float32), loops, gt
