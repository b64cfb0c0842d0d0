"""The dense/sparse bundle-adjustment problem of ``scripts/bench_ba_sparse.py``
in numpy (no JAX), shared by ``chip_smoke.py`` and the port's card tests.

W poses stepping 0.3 m along x, M landmarks in a box 8-16 m ahead, each
seen by ``track_len`` consecutive poses with 5e-4 normalized noise
(the sprite world's track length at the full pipeline's shapes), the
landmarks started 0.02 off, pose 0 fixed. The same draws as the script's
``make_problem``.
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
