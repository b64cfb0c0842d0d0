"""The world and configuration of ``bench.py``'s ``bench_loop_pipeline``, for
either package: numpy only, generic over the ``Config`` class, shared by
``scripts/loop_pipeline_reference.py`` (the JAX package on the CPU) and
``chip_smoke.py`` (the port on the card).

A camera drives ``render.loop_path`` (200 frames of 0.25 m, turning through
1.06 circles) around a ring of 2400 sprites at KITTI's 376x1240 and f =
718.856. Each frame carries photometric stress: a sinusoidal brightness
drift of 5 % (period 50 frames) and Gaussian noise of sigma 2.0 grey
levels, drawn from the same generator after the world, in the order
``bench_loop_pipeline`` draws them (bench.py:579-595), so the frames are the
bench's frames. The configuration is the bench's (bench.py:599-611): 2000
features, keyframe interval 4, self-promoting chunks of 8 with a heavy
boundary every second promotion, f16 upload, one BA bucket.

The small ring (``small_ring_frames``, ``small_ring_config``) is
``tests/test_compiled_slam.py``'s ``test_compiled_slam_devpromo_loop_closing``
world: 100 frames around 420 sprites at 320x240, 320 features, chunks of 4
with in-chunk promotion, loop closing on; the JAX test asserts a closure
there.
"""
from __future__ import annotations

import numpy as np

from render import loop_path, make_ring_world, render

N_FRAMES = 200
STEP = 0.25
CLOSES = 1.06
WIDTH, HEIGHT, FOCAL = 1240, 376, 718.856
N_SPRITES = 2400
NOISE = 2.0
BRIGHT = 0.05
SEED = 11
N_FEATURES = 2000
CHUNK = 8
DT = 0.1  # timestamp step: frame i at i * DT


def loop_frames(n_frames: int = N_FRAMES, width: int = WIDTH, height: int = HEIGHT, f: float = FOCAL,
                n_sprites: int = N_SPRITES, noise: float = NOISE, bright: float = BRIGHT, seed: int = SEED):
    """Renders the ring sequence. Returns (frames (n, H, W) f32, K (3, 3),
    T_gt (n, 4, 4) true T_w2c)."""
    rng = np.random.default_rng(seed)
    Ts = loop_path(n_frames, step=STEP, closes=CLOSES)
    yaw_rate = 2 * np.pi * CLOSES / n_frames
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0,
                            n_sprites=n_sprites, y_range=(-6, 6))
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    frames = np.empty((n_frames, height, width), np.float32)
    for i, T in enumerate(Ts):
        img = render(world, T, K, width, height).astype(np.float32)
        img = img * (1.0 + bright * np.sin(2 * np.pi * i / 50.0))
        img = img + rng.normal(0, noise, img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.float32)
    return frames, K, Ts


def loop_config(Config, loop_on: bool, num_features: int = N_FEATURES, chunk_size: int = CHUNK):
    """``bench_loop_pipeline``'s configuration in either package's ``Config``."""
    cfg = Config()
    cfg.feature.num_features = num_features
    cfg.tracking.keyframe_interval = 4
    cfg.tracking.chunk_size = chunk_size
    cfg.tracking.device_promotion = True
    cfg.tracking.heavy_boundary_every = 2
    cfg.tracking.upload_f16 = True
    cfg.optimization.max_points = 4096
    cfg.optimization.window_size = 16
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = 2048
    cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
    cfg.loop_closing.enabled = loop_on
    return cfg


def warm_end(boot_end: int, n_frames: int, chunk_size: int = CHUNK, heavy_every: int = 2) -> int:
    """The first timed frame after a bootstrap that ended before frame
    ``boot_end``: two heavy-boundary cycles run before the clock
    (bench_loop_pipeline's policy)."""
    return min(boot_end + 2 * max(chunk_size, 4) * heavy_every + 1, n_frames - 4 * chunk_size)


def ate_pct(ate_rmse, ts, Tw, T_gt, dt: float = DT):
    """Scale-aligned ATE of the per-frame poses ``Tw`` (T_w2c at timestamps
    ``ts``) against the true poses, in metres and in % of the true path over
    the whole sequence (bench.py:634-638), through either package's
    ``utils.metrics.ate_rmse``. Returns (rmse m, % of path)."""
    gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_gt])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    idx = [int(round(t / dt)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    rmse = float(ate_rmse(est, gt[idx], align_scale=True)["rmse"])
    return rmse, 100.0 * rmse / max(path_len, 1e-9)


def small_ring_frames(n_frames: int = 100, step: float = STEP, f: float = 260.0, width: int = 320,
                      height: int = 240, seed: int = SEED):
    """test_compiled_slam_devpromo_loop_closing's frames. Returns (frames
    (list of (H, W) f32), K, T_gt (n, 4, 4))."""
    rng = np.random.default_rng(seed)
    Ts = loop_path(n_frames, step=step, closes=CLOSES)
    radius = step / (2 * np.sin(np.pi * CLOSES / n_frames))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
    return [render(world, T, K, width, height) for T in Ts], K, Ts


def small_ring_config(Config):
    """test_compiled_slam_devpromo_loop_closing's configuration."""
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.local_map_size = 2048
    cfg.tracking.chunk_size = 4
    cfg.tracking.device_promotion = True
    cfg.optimization.window_size = 6
    cfg.loop_closing.enabled = True
    return cfg
