"""Worlds and configurations of the host SLAM facade runs (numpy only).

Shared by ``chip_smoke.py``'s facade phases, ``scripts/facade_reference.py``
(either package on the CPU) and the port's facade tests, so every run of a
world sees the same frames and settings. Each ``*_config`` takes the
``Config`` class of the package that runs it (the fields are identical).

* ``deploy``: ``bench.synth_kitti_frames(64, seed=3, step=0.6,
  n_sprites=1500)`` at 376x1240 with the settings of
  ``bench.bench_full_pipeline`` that the facade reads (2000 features, 4
  levels, keyframe interval 4, BA window 16, 4096 points, buckets 32 x
  2048, the initializer's ``min_inliers``), loop closing off.
* ``e2e``: tests/test_slam_e2e.py's 12-frame 320x240 world and
  ``small_config``.
* ``families``: the deploy world's first ``FAMILY_FRAMES`` frames and
  settings, with the detector and matcher of each feature family
  (``FAMILIES``): DoG SIFT + L2 (``sift_config``'s detector parameters),
  GradHist + L2 and Shi-Tomasi ORB + Hamming, each at its RANSAC seeds; and
  tests/test_float_family_slam.py's world (``e2e_frames(10)``) with its
  ``sift_config``, or that configuration with another family's detector and
  matcher, for a family the JAX package cannot track through the deploy world.
* ``endurance``: ``bench.bench_loop_endurance_device``'s world and
  configuration: a 320x240 ring, 200 frames, a texture blackout at frames
  60-62, sensor noise and a brightness drift, 320 features,
  ``max_landmarks`` 2500.
"""
from __future__ import annotations

import time

import numpy as np

DT = 0.1  # seconds between frames: a frame's index is round(timestamp / DT)


def deploy_frames(n_frames: int = 64):
    """(frames, K, T_w2c ground truth) of the deployment world."""
    import bench

    return bench.synth_kitti_frames(n_frames=n_frames, seed=3, step=0.6, n_sprites=1500)


def deploy_config(Config, num_features: int = 2000):
    cfg = Config()
    cfg.feature.num_features = num_features
    cfg.feature.num_pyramid_levels = 4
    cfg.tracking.keyframe_interval = 4
    cfg.optimization.max_points = 4096
    cfg.optimization.window_size = 16
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = 2048
    cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
    cfg.loop_closing.enabled = False
    return cfg


FAMILY_FRAMES = 32
# family -> (detector, matcher, detector_params, RANSAC seeds); 13 is the tracker's default.
FAMILIES = {
    "sift": ("sift", "l2", {"n_octaves": 3, "contrast_threshold": 0.02}, (13, 0, 1, 2)),
    "gradhist": ("gradhist", "l2", {}, (13, 0)),
    "shi_tomasi_orb": ("shi_tomasi_orb", "bf_hamming", {}, (13, 0)),
}


def family_config(Config, family: str):
    """The deploy settings with ``family``'s detector and matcher."""
    detector, matcher, params, _ = FAMILIES[family]
    cfg = deploy_config(Config)
    cfg.feature.detector_name = detector
    cfg.feature.matcher_name = matcher
    cfg.feature.detector_params = dict(params)
    return cfg


def endurance_frames(n_frames: int = 200, blackout=range(60, 63)):
    """(frames, K, T_w2c ground truth) of bench_loop_endurance_device's ring:
    the same draws in the same order as the bench."""
    from render import loop_path, make_ring_world, render

    step, W, H, F = 0.25, 320, 240, 260.0
    rng = np.random.default_rng(11)
    Ts = loop_path(n_frames, step=step, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / n_frames
    radius = step / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    frames = []
    for i, T in enumerate(Ts):
        img = np.full((H, W), 110.0, np.float32) if i in blackout else render(world, T, K, W, H)
        img = img * (1.0 + 0.05 * np.sin(2 * np.pi * i / 50.0))
        img = img + rng.normal(0, 2.0, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    return frames, K, np.stack(Ts)


def endurance_config(Config, loop_on: bool):
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.optimization.window_size = 6
    cfg.optimization.ba_every_n_keyframes = 2
    cfg.map.cull_redundant_keyframes = True
    cfg.map.min_keyframes_before_cull = 6
    cfg.map.max_landmarks = 2500
    cfg.loop_closing.enabled = loop_on
    return cfg


def e2e_frames(n_frames: int = 12):
    """(frames, K, T_w2c ground truth) of tests/test_slam_e2e.py's world."""
    from render import render_sequence

    frames, Ts, K, _ = render_sequence(np.random.default_rng(42), n_frames=n_frames, step=0.35)
    return frames, K, np.stack(Ts)


def e2e_config(Config):
    """tests/test_slam_e2e.py's ``small_config``."""
    cfg = Config()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.initialization.min_parallax_deg = 0.5
    cfg.initialization.essential_hypotheses = 128
    cfg.tracking.min_inliers = 10
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.tracking.pnp_hypotheses = 128
    cfg.optimization.n_iter = 12
    cfg.optimization.window_size = 8
    cfg.local_mapping.max_neighbors = 2
    cfg.local_mapping.min_parallax_deg = 0.3
    return cfg


def sift_config(Config, family: str = "sift"):
    """tests/test_float_family_slam.py's ``sift_config``, with ``family``'s
    detector and matcher (``FAMILIES``)."""
    detector, matcher, params, _ = FAMILIES[family]
    cfg = Config()
    cfg.feature.detector_name = detector
    cfg.feature.matcher_name = matcher
    cfg.feature.num_features = 384
    cfg.feature.detector_params = dict(params)
    cfg.initialization.min_inliers = 40
    cfg.initialization.min_parallax_deg = 0.5
    cfg.initialization.essential_hypotheses = 128
    cfg.tracking.min_inliers = 10
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.tracking.pnp_hypotheses = 128
    cfg.optimization.n_iter = 12
    cfg.optimization.window_size = 8
    cfg.local_mapping.max_neighbors = 2
    cfg.local_mapping.min_parallax_deg = 0.3
    return cfg


def centers(Ts) -> np.ndarray:
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])


def ate(ate_rmse, timestamps, Ts_est, Ts_gt) -> dict:
    """Scale-aligned ATE of the poses at ``timestamps`` in metres and in %
    of the ground-truth path from the first to the last of those frames."""
    idx = [int(round(t / DT)) for t in timestamps]
    gt = centers(Ts_gt[idx[0]:idx[-1] + 1])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    rmse = float(ate_rmse(centers(Ts_est), centers(Ts_gt[idx]), align_scale=True)["rmse"])
    return {"m": rmse, "pct": 100.0 * rmse / max(path, 1e-9), "path_m": path, "n": len(idx)}


def run(slam, frames, on_frame=None) -> dict:
    """Track every frame through ``slam.track``; returns the per-frame states,
    the relocalization count, the tracked pose of each frame that ended OK
    (``slam.tracking.last_frame`` after the call) and the wall seconds from
    the first OK frame on. ``on_frame(i, info)`` sees each call's info."""
    states, relocs, poses, closures = [], 0, [], 0
    t_ok = None
    for i, img in enumerate(frames):
        info = slam.track([img], timestamp=i * DT)
        states.append(info.get("state"))
        relocs += bool(info.get("relocalized"))
        closures += info.get("loop_closed") is not None
        if info.get("state") == "OK":
            if t_ok is None:
                t_ok = (i, time.perf_counter())
            lf = slam.tracking.last_frame
            poses.append((i * DT, np.array(lf.T_w2c)))
        if on_frame is not None:
            on_frame(i, info)
    boot = t_ok[0] if t_ok else len(frames)
    secs = time.perf_counter() - t_ok[1] if t_ok else 0.0
    return {"states": states, "relocs": relocs, "poses": poses, "closures_seen": closures, "boot": boot,
            "secs_after_boot": secs}


def trace_entry(i: int, info: dict) -> str:
    """One frame of a run's trace: ``i:guided/pairs/inliers``, ``K`` after a
    new keyframe, ``R`` after a relocalization, ``-`` for a count the frame
    did not report (bootstrap, LOST)."""
    counts = "/".join(str(info.get(k, "-")) for k in ("n_guided", "n_3d2d", "n_inliers"))
    return f"{i}:{counts}{'K' if info.get('new_keyframe') else ''}{'R' if info.get('relocalized') else ''}"


def summary(slam, result, Ts_gt, ate_rmse) -> dict:
    """Keyframe (``SLAM.trajectory()``) and per-frame ATE, counts, state."""
    traj = slam.trajectory()
    out = {
        "state": slam.state.name,
        "boot_frame": result["boot"],
        "keyframes": slam.map.num_keyframes(),
        "landmarks": slam.map.num_map_points(),
        "lost_after_boot": sum(s == "LOST" for s in result["states"][result["boot"]:]),
        "relocalizations": result["relocs"],
        "closures": len(slam.loop_closing.closed_loops) if slam.loop_closing is not None else 0,
    }
    if len(traj) >= 3:
        out["ate_keyframes"] = ate(ate_rmse, [t for _, t, _ in traj], [T for _, _, T in traj], Ts_gt)
    if len(result["poses"]) >= 3:
        out["ate_frames"] = ate(ate_rmse, [t for t, _ in result["poses"]], [T for _, T in result["poses"]], Ts_gt)
    n_after = len(result["states"]) - result["boot"] - 1
    out["fps_after_boot"] = n_after / result["secs_after_boot"] if result["secs_after_boot"] > 0 else 0.0
    return out
