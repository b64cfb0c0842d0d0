"""Worlds and configurations of the stereo and RGB-D facade runs (numpy only).

Shared by ``chip_smoke.py``'s stereo and RGB-D facade phases,
``scripts/depth_facade_reference.py`` (either package on the CPU) and the
port's depth-facade tests, so every run of a world sees the same frames and
settings. Each ``*_config`` takes the ``Config`` class of the package that
runs it (the fields are identical).

* ``stereo``: ``bench.bench_stereo_pipeline``'s world,
  ``bench.synth_kitti_frames(48, seed=3, step=0.6, n_sprites=1500,
  baseline=0.54)``: 376x1240, f = 718.856, bf = 388.18 px m (the KITTI
  rig), right camera at +0.54 m along the left camera's x axis; the
  facade's deployment settings (``facade_world.deploy_config``: 2000
  features, 4 levels, BA window 16, loop closing off).
* ``rgbd``: TUM fr1 as ORB-SLAM2's ``Examples/RGB-D/TUM1.yaml`` gives it
  (640x480, fx = fy = 517.306, cx = 318.643, cy = 255.314, 1000 features;
  4 pyramid levels where TUM1.yaml has 8), the world of the JAX package's
  RGB-D test (``render.make_world(default_rng(9))``) over
  ``render.camera_path(32, step=0.3)``, rendered by ``render_with_depth``
  at that size; depth in metres (``depth_scale`` 1.0), 0 where no sprite.
* The e2e worlds of tests/test_stereo_rgbd.py: 320x240, f = 260, the
  stereo world (seed 5, 10 frames, baseline 0.5) and the RGB-D world
  (seed 9, 8 frames) with that test's ``small_config``.
"""
from __future__ import annotations

import numpy as np

import facade_world as fw

DT = fw.DT
STEREO_BASELINE = 0.54
TUM1_W, TUM1_H = 640, 480
TUM1_K = np.array([[517.306, 0.0, 318.643], [0.0, 517.306, 255.314], [0.0, 0.0, 1.0]])
E2E_BASELINE = 0.5
E2E_K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])


def stereo_frames(n_frames: int = 48):
    """(left frames, right frames, K, T_w2c ground truth) of the stereo world."""
    import bench

    return bench.synth_kitti_frames(n_frames=n_frames, seed=3, step=0.6, n_sprites=1500,
                                    baseline=STEREO_BASELINE)


def stereo_config(Config):
    cfg = fw.deploy_config(Config)
    cfg.camera.sensor_type = "stereo"
    return cfg


def rgbd_frames(n_frames: int = 32):
    """(gray frames, depth maps in metres, K, T_w2c ground truth) of the RGB-D world."""
    from render import camera_path, make_world, render_with_depth

    world = make_world(np.random.default_rng(9))
    Ts = camera_path(n_frames, step=0.3)
    imgs, depths = zip(*(render_with_depth(world, T, TUM1_K, TUM1_W, TUM1_H) for T in Ts))
    return list(imgs), list(depths), TUM1_K.copy(), np.stack(Ts)


def rgbd_config(Config):
    cfg = fw.deploy_config(Config, num_features=1000)
    cfg.camera.sensor_type = "rgbd"
    cfg.tracking.depth_scale = 1.0
    return cfg


def e2e_stereo_frames(n_frames: int = 10):
    """tests/test_stereo_rgbd.py's stereo world: (lefts, rights, K, Ts)."""
    from render import camera_path, make_world, stereo_pair

    world = make_world(np.random.default_rng(5))
    Ts = camera_path(n_frames, step=0.3)
    pairs = [stereo_pair(world, T, E2E_K, E2E_BASELINE, 320, 240) for T in Ts]
    return [p[0] for p in pairs], [p[1] for p in pairs], E2E_K.copy(), np.stack(Ts)


def e2e_rgbd_frames(n_frames: int = 8):
    """tests/test_stereo_rgbd.py's RGB-D world: (images, depths, K, Ts)."""
    from render import camera_path, make_world, render_with_depth

    world = make_world(np.random.default_rng(9))
    Ts = camera_path(n_frames, step=0.3)
    imgs, depths = zip(*(render_with_depth(world, T, E2E_K, 320, 240) for T in Ts))
    return list(imgs), list(depths), E2E_K.copy(), np.stack(Ts)


def e2e_config(Config, sensor: str, fused: bool = False):
    """tests/test_stereo_rgbd.py's settings: ``small_config`` with the sensor,
    ``min_inliers`` 30 and optionally the fused pipeline."""
    cfg = fw.e2e_config(Config)
    cfg.camera.sensor_type = sensor
    cfg.initialization.min_inliers = 30
    cfg.tracking.fused_pipeline = fused
    return cfg


def track_args(sensor: str, frames, i: int):
    """(images, depth) of frame ``i`` as ``SLAM.track`` takes them: ``frames``
    is (lefts, rights) for stereo, (images, depths) for RGB-D."""
    a, b = frames
    return ([a[i], b[i]], None) if sensor == "stereo" else ([a[i]], b[i])


def metric_ate(slam, Ts_gt, ate_rmse) -> dict:
    """Keyframe ATE of ``SLAM.trajectory()`` without scale alignment (metres
    and % of the path between the first and last keyframe) and the scale a
    Sim(3) fit would take (``scale``); None under 3 keyframes."""
    traj = slam.trajectory()
    if len(traj) < 3:
        return None
    idx = [int(round(t / DT)) for _, t, _ in traj]
    gt = fw.centers(Ts_gt[idx])
    est = fw.centers([T for _, _, T in traj])
    path = float(np.linalg.norm(np.diff(fw.centers(Ts_gt[idx[0]:idx[-1] + 1]), axis=0), axis=1).sum())
    rmse = float(ate_rmse(est, gt, align_scale=False)["rmse"])
    return {"m": rmse, "pct": 100.0 * rmse / max(path, 1e-9), "path_m": path, "n": len(idx),
            "scale": float(ate_rmse(est, gt, align_scale=True)["scale"])}


def classify(lost_after_boot: int, ate, jump_pct: float) -> str:
    """A run is LOST (any LOST frame after the bootstrap), a scale jump
    (metric keyframe ATE above ``jump_pct`` % of the path, or under 3
    keyframes) or clean."""
    if lost_after_boot:
        return "LOST"
    return "scale jump" if ate is None or ate["pct"] > jump_pct else "clean"


def kp_z_share(frame) -> float | None:
    """Share of the frame's keypoint slots holding a valid depth: the function
    bench.py reports as ``stereo_kp_z_valid_frac`` (valid depth and valid
    keypoint over all ``num_features`` slots); None without depths."""
    if frame is None or getattr(frame, "kp_z_valid", None) is None:
        return None
    ok = np.asarray(frame.kp_z_valid) & np.asarray(frame.valid_mask(0))
    return float(ok.mean())
