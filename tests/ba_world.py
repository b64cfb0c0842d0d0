"""The dense/sparse bundle-adjustment problem of ``scripts/bench_ba_sparse.py``
in numpy (no JAX), shared by ``chip_smoke.py`` and the port's card tests.

W poses stepping 0.3 m along x, M landmarks in a box 8-16 m ahead, each
seen by ``track_len`` consecutive poses with 5e-4 normalized noise
(the sprite world's track length at the full pipeline's shapes), the
landmarks started 0.02 off, pose 0 fixed. The same draws as the script's
``make_problem``. ``bench_problem``: bench.py's BA problem (W = 10, M =
4096), the one the Adam solver is measured on.
"""
from __future__ import annotations

import numpy as np


def make_problem(W: int, M: int, K: int, track_len: int = 4, seed: int = 0):
    """Returns (dense, sparse): dicts of the ``BAProblem`` and ``BASparse``
    fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(8, 16, M)], axis=1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for w in range(W):
        T[w, :3, 3] = [-0.3 * w, 0.0, 0.0]
    start = rng.integers(0, max(W - track_len, 1), M)
    uv_d = np.zeros((M, W, 2), np.float32)
    valid_d = np.zeros((M, W), bool)
    uv_s = np.zeros((M, K, 2), np.float32)
    pose_s = np.zeros((M, K), np.int32)
    valid_s = np.zeros((M, K), bool)
    for i in range(M):
        for k in range(track_len):
            j = int(start[i]) + k
            pc = T[j, :3, :3] @ pts[i] + T[j, :3, 3]
            ob = pc[:2] / pc[2] + rng.normal(0, 5e-4, 2)
            uv_d[i, j] = ob
            valid_d[i, j] = True
            uv_s[i, k] = ob
            pose_s[i, k] = j
            valid_s[i, k] = True
    pose_valid = np.ones(W, bool)
    pose_fixed = np.zeros(W, bool)
    pose_fixed[0] = True
    common = dict(T_w2c=T, points=pts + np.float32(0.02), pose_valid=pose_valid, pose_fixed=pose_fixed)
    dense = dict(common, uv=uv_d, obs_valid=valid_d)
    sparse = dict(common, uv=uv_s, obs_pose=pose_s, obs_valid=valid_s)
    return dense, sparse


def bench_problem(M: int = 4096, W: int = 10, noise: float = 0.05, seed: int = 1):
    """bench.py's ``make_ba_problem`` in numpy: W poses stepping 0.8 m
    along x, M landmarks in a box 8-50 m ahead seen noise-free by every pose
    in front of which they lie (z > 1), the landmarks started ``noise`` off,
    pose 0 fixed; the first problem of ``bench_ba``'s draws (seed 1).
    Returns a dict of the ``BAProblem`` fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-20, 30, M), rng.uniform(-8, 8, M), rng.uniform(8, 50, M)], 1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    for j in range(W):
        T[j, 0, 3] = -0.8 * j
    uv = np.zeros((M, W, 2), np.float32)
    valid = np.zeros((M, W), bool)
    for j in range(W):
        pc = pts @ T[j, :3, :3].T + T[j, :3, 3]
        uv[:, j] = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
        valid[:, j] = pc[:, 2] > 1.0
    return dict(T_w2c=T, points=pts + rng.normal(0, noise, pts.shape).astype(np.float32), uv=uv, obs_valid=valid,
                pose_valid=np.ones(W, bool), pose_fixed=np.array([True] + [False] * (W - 1)))


# How close two float32 runs of ``adam_bundle_adjust`` on one problem come
# (the port against the JAX package on the CPU, tests/test_torch_adam.py;
# the card against the CPU, chip_smoke.py's adam phase): cost0 relative, the
# cost curve relative, poses and landmarks absolute after 150 steps. The
# port against JAX measured 1.5e-7, 3.8e-5, 9.5e-7 and 1.5e-5 on
# test_ba.py's and this module's bench problem (M 512 and 4096).
ADAM_COST0_RTOL, ADAM_COSTS_RTOL, ADAM_T_ATOL, ADAM_X_ATOL = 1e-6, 2e-4, 1e-5, 2e-4
