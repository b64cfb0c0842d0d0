"""bench.py's ``bench_stereo_step`` world and the stereo depth funnel, in
numpy only, shared by scripts/stereo_step_reference.py (either package on
the CPU) and chip_smoke.py's stereo step phase (the port on the card).

The world is ``bench.synth_kitti_frames(n_frames=12, seed=5, step=0.5,
baseline=0.54)``: 376x1240, f = 718.856, 900 flat square sprites of one
intensity each at depths 8-50 m, the camera moving 0.5 m a frame along +x,
the right camera 0.54 m to the right of the left one (KITTI's rig). The
step runs at 2000 features, 4 levels, FAST threshold 20 and grid 8 (the
defaults), without the local map.

``depth_funnel`` counts, on one pair, the left keypoints that survive each
stage of the row-gated stereo match (``ops.stereo.stereo_feature_depths``
of both packages, re-done here from the features alone), and
``depth_geometry`` what the world's geometry allows: where each valid left
keypoint's sprite lies, and whether the right camera sees it.
"""
from __future__ import annotations

import numpy as np

N_PAIRS, SEED, STEP, BASELINE = 12, 5, 0.5, 0.54
N_FEATURES, N_LEVELS = 2000, 4
N_STEPS = 60  # bench's timed steps, cycled over pairs 1-11
ROW_TOLERANCE, MIN_DISPARITY, RATIO, MIN_DEPTH = 2.0, 0.1, 0.8, 0.1
FAR_DEPTH = 20.0  # bench's landmark depth where a slot has no measured depth
# synth_kitti_frames' world: its draws and sizes, in its order.
H, W, FOCAL, N_SPRITES = 376, 1240, 718.856, 900


def step_kwargs() -> dict:
    """The step's settings in bench_stereo_step (both packages' names)."""
    return dict(num_features=N_FEATURES, n_levels=N_LEVELS, stereo=True, baseline=BASELINE)


def bench_world(seed: int = SEED):
    """(pairs (12, 2, H, W) f32, K, Ts (12, 4, 4)) of bench_stereo_step's
    world (``seed`` 5; the batched phase's sequences use 5 + s)."""
    import bench

    lefts, rights, K, Ts = bench.synth_kitti_frames(n_frames=N_PAIRS, seed=seed, step=STEP, baseline=BASELINE)
    return np.stack([np.stack([l, r]) for l, r in zip(lefts, rights)]).astype(np.float32), K, Ts


def landmarks_from_depths(K, xy, z, z_ok):
    """bench_stereo_step's frame-0 landmarks: each slot backprojected at its
    measured depth, or at FAR_DEPTH where it has none; a slot has a landmark
    where it has a depth. Returns ((N, 3) f32, (N,) bool)."""
    rays = np.concatenate([xy, np.ones((len(xy), 1), np.float32)], 1) @ np.linalg.inv(K).T
    return (rays * np.where(z_ok, z, FAR_DEPTH)[:, None]).astype(np.float32), np.asarray(z_ok, bool)


def hamming(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) 32-bit words (any integer dtype) -> (Na, Nb) int."""
    bits = [np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=1).astype(np.float32) for d in (desc_a, desc_b)]
    return (bits[0].sum(1)[:, None] + bits[1].sum(1)[None, :] - 2 * bits[0] @ bits[1].T).astype(np.int64)


def depth_funnel(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r, bf, min_depth=MIN_DEPTH) -> dict:
    """Left keypoints surviving each stage of the row-gated match: valid;
    with a valid right keypoint inside the row and disparity gate; passing
    the ratio test on the gated distances; passing the cross-check; with z
    > min_depth (the step's depth-valid slots). Also returns ``valid_slots``
    (the last stage's mask), to be held against the step's ``kp_z_valid``."""
    big = 10**9
    d = np.where(valid_l[:, None] & valid_r[None, :], hamming(desc_l, desc_r), big)
    dv = np.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    gate = (dv <= ROW_TOLERANCE) & (disp > MIN_DISPARITY) & (disp < bf / min_depth)
    d = np.where(gate, d, big)
    ri = np.argmin(d, 1)
    best = d[np.arange(len(d)), ri]
    second = np.where(np.arange(d.shape[1])[None, :] == ri[:, None], big * 2, d).min(1)
    candidate = best < big // 2
    ratio = candidate & (best < RATIO * second)
    cross = ratio & (np.argmin(d, 0)[ri] == np.arange(len(d)))
    z = bf / np.maximum(xy_l[:, 0] - xy_r[ri, 0], 1e-9)
    deep = cross & (z > min_depth)
    return {"valid": int(valid_l.sum()), "in_gate": int(candidate.sum()), "ratio": int(ratio.sum()),
            "cross_check": int(cross.sum()), "z_gt_min_depth": int(deep.sum()), "valid_slots": deep}


def _sprites(seed: int):
    """synth_kitti_frames' sprites: centres, half-sizes, intensities."""
    rng = np.random.default_rng(seed)
    span = max(30.0, STEP * N_PAIRS + 20.0)
    xs = rng.uniform(-30, 10 + span, N_SPRITES)
    pts = np.stack([xs, rng.uniform(-8, 8, N_SPRITES), rng.uniform(8, 50, N_SPRITES)], 1)
    return pts, rng.uniform(0.15, 0.6, N_SPRITES), rng.uniform(20, 255, N_SPRITES)


def _id_buffer(pts, sizes, cam_x):
    """Per pixel, the sprite that synth_kitti_frames paints last (the
    nearest) for a camera at x = cam_x, or -1 for the background; and each
    sprite's depth."""
    ids = np.full((H, W), -1, np.int64)
    pc = pts - np.array([cam_x, 0.0, 0.0])
    for idx in np.argsort(-pc[:, 2]):
        x, y, z = pc[idx]
        if z < 1.0:
            continue
        u, v, s = FOCAL * x / z + W / 2, FOCAL * y / z + H / 2, FOCAL * sizes[idx] / z
        ix0, ix1 = max(int(u - s), 0), min(int(np.ceil(u + s)), W)
        iy0, iy1 = max(int(v - s), 0), min(int(np.ceil(v + s)), H)
        if ix1 > ix0 and iy1 > iy0:
            ids[iy0:iy1, ix0:ix1] = idx
    return ids, pc[:, 2]


def depth_geometry(xy, valid, frame: int = 0, seed: int = SEED, left_image=None, win: int = 2) -> dict:
    """What the world allows for the valid left keypoints ``xy`` of pair
    ``frame``: each takes the nearest sprite in its (2 win + 1)^2 window
    (a FAST corner sits on a sprite's corner, inside or beside it). Counts
    keypoints on no sprite; on a junction of two or more sprites (a corner
    that is no point of the world: it slides between the views); whose
    sprite's point falls inside the right image (u - f b / z >= 0); and
    whose sprite the right camera also sees there (not occluded). With
    ``left_image`` the re-drawn world is first checked against the frame."""
    pts, sizes, intens = _sprites(seed)
    cam = STEP * frame
    ids_l, z = _id_buffer(pts, sizes, cam)
    ids_r, _ = _id_buffer(pts, sizes, cam + BASELINE)
    if left_image is not None:
        drawn = np.where(ids_l >= 0, intens[np.maximum(ids_l, 0)], 110.0).astype(np.float32)
        if not np.array_equal(drawn, left_image):
            raise AssertionError("the re-drawn sprite world differs from bench.synth_kitti_frames' frame")
    counts = dict(valid=0, on_background=0, on_junction=0, inside_right=0, seen_by_right=0)
    for x, y in np.asarray(xy)[np.asarray(valid)]:
        u, v = int(round(float(x))), int(round(float(y)))
        win_l = ids_l[max(v - win, 0):v + win + 1, max(u - win, 0):u + win + 1]
        sp = np.unique(win_l[win_l >= 0])
        counts["valid"] += 1
        if len(sp) == 0:
            counts["on_background"] += 1
            continue
        counts["on_junction"] += len(sp) >= 2
        s = sp[np.argmin(z[sp])]
        u_r = float(x) - FOCAL * BASELINE / z[s]
        if u_r < 0:
            continue
        counts["inside_right"] += 1
        ur = int(round(u_r))
        win_r = ids_r[max(v - win, 0):v + win + 1, max(ur - win, 0):ur + win + 1]
        counts["seen_by_right"] += bool((win_r == s).any())
    n = max(counts["valid"], 1)
    counts.update({f"{k}_share": counts[k] / n for k in ("on_background", "on_junction", "inside_right",
                                                         "seen_by_right")})
    return counts
