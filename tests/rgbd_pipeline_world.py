"""The worlds, configurations and runs of RGB-D ``CompiledSLAM``
(``camera.sensor_type = "rgbd"``), for either package: numpy only, generic
over the ``Config`` class, shared by ``scripts/rgbd_pipeline_reference.py``
(either package on the CPU, the port also on the card),
``tests/test_torch_rgbd_compiled_slam.py`` and ``chip_smoke.py``'s RGB-D
pipeline phase.

Neither package has an RGB-D tracking step: an RGB-D system bootstraps from
one frame and its depth map (``Initializer._initialize_rgbd``), then runs the
mono step, the mono chunk and mono promotion with triangulation.

* ``tum``: TUM fr1 as ORB-SLAM2's ``Examples/RGB-D/TUM1.yaml`` gives it
  (640x480, fx = fy = 517.306, 1000 features; 4 pyramid levels where
  TUM1.yaml has 8), ``depth_world.rgbd_frames(32)``: the JAX RGB-D test's
  sprite world over ``render.camera_path(32, step=0.3)`` with metric depth
  maps. ``depth_world.rgbd_config`` (the facades' deployment settings) with
  ``keyframe_interval`` 2, self-promoting chunks of 8 and a heavy boundary
  every second promotion. At the facades' ``keyframe_interval`` 4 the JAX
  package's ``CompiledSLAM`` keeps its one keyframe and goes LOST at the
  first chunk boundary for good (``--keyframe-interval 4`` of the
  reference script records it).
* ``small``: ``depth_world.e2e_rgbd_frames(16)`` (320x240, f = 260) with
  ``depth_world.e2e_config(..., "rgbd")``, tests/test_stereo_rgbd.py's
  settings, through each route (``ROUTES``): frame by frame, plain chunks
  of 4 and self-promoting chunks of 4.

The run: frames fed one by one from frame 0 until the bootstrap (at most
``BOOT_FRAMES``), a warm-up of one chunk, then the rest with ``flush()``
inside the timed window; every frame is tracked. The ATE is metric: no
scale alignment (an RGB-D map is metric).
"""
from __future__ import annotations

import numpy as np

import depth_world as dw

N_FRAMES, KF_INTERVAL, CHUNK = 32, 2, 8
SMALL_FRAMES = 16
BOOT_FRAMES = 4
DT = dw.DT  # frame i at i * DT
ROUTES = {  # route: (chunk size, device promotion)
    "single": (1, False),
    "plain": (4, False),
    "promotion": (4, True),
}


def tum_frames(n_frames: int = N_FRAMES):
    """(images (n, H, W) f32, depth maps (n, H, W) f32 in metres, K, T_w2c ground truth)."""
    imgs, depths, K, Ts = dw.rgbd_frames(n_frames)
    return np.stack(imgs), np.stack(depths), K, Ts


def tum_config(Config, keyframe_interval: int = KF_INTERVAL):
    """``depth_world.rgbd_config`` with the pipeline's chunking: self-promoting
    chunks of CHUNK, keyframe interval ``keyframe_interval``."""
    cfg = dw.rgbd_config(Config)
    cfg.tracking.keyframe_interval = keyframe_interval
    cfg.tracking.chunk_size = CHUNK
    cfg.tracking.device_promotion = True
    return cfg


def small_frames(n_frames: int = SMALL_FRAMES):
    imgs, depths, K, Ts = dw.e2e_rgbd_frames(n_frames)
    return np.stack(imgs), np.stack(depths), K, Ts


def small_config(Config, route: str):
    chunk, promo = ROUTES[route]
    cfg = dw.e2e_config(Config, "rgbd")
    cfg.tracking.chunk_size = chunk
    cfg.tracking.device_promotion = promo
    return cfg


def camera(PinholeCamera, imgs, K):
    return PinholeCamera(width=imgs[0].shape[1], height=imgs[0].shape[0], K=np.asarray(K, np.float64))


def camera_centre(T_w2c) -> np.ndarray:
    return -T_w2c[:3, :3].T @ T_w2c[:3, 3]


def _centres(ts, Ts, Ts_gt):
    idx = [int(round(t / DT)) for t in ts]
    return np.stack([camera_centre(T) for T in Ts]), np.stack([camera_centre(Ts_gt[j]) for j in idx])


def metric_ate(ate_rmse, ts, Ts, Ts_gt) -> tuple[float, float, float]:
    """(rmse m, % of the path, path m) of the camera centres against ground
    truth, without scale alignment, by the package's own ``ate_rmse``."""
    est, gt = _centres(ts, Ts, Ts_gt)
    rmse = float(ate_rmse(est, gt, align_scale=False)["rmse"])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return rmse, 100.0 * rmse / max(path, 1e-9), path


def scale_fit(ate_rmse, ts, Ts, Ts_gt) -> tuple[float, float]:
    """(rmse m after a similarity alignment, the fitted scale)."""
    res = ate_rmse(*_centres(ts, Ts, Ts_gt), align_scale=True)
    return float(res["rmse"]), float(res["scale"])


class Probe:
    """Wraps ``slam``'s ``_adopt_device_keyframe``, ``_boundary_heavy`` and
    its optimizer's ``solve_finish`` (same names in both packages) to count
    the device promotions adopted and the slots each minted
    (``rec.ref_tri``), the heavy boundaries, and the BA solves that landed."""

    def __init__(self, slam):
        self.minted: list[int] = []
        self.heavy_boundaries = 0
        self.ba_solves = 0
        adopt0, heavy0, finish0 = slam._adopt_device_keyframe, slam._boundary_heavy, slam.optimizer.solve_finish

        def adopt(out, rec, *a, **k):
            self.minted.append(int(np.asarray(rec.ref_tri).sum()))
            return adopt0(out, rec, *a, **k)

        def heavy(*a, **k):
            self.heavy_boundaries += 1
            return heavy0(*a, **k)

        def finish(*a, **k):
            self.ba_solves += 1
            return finish0(*a, **k)

        slam._adopt_device_keyframe, slam._boundary_heavy, slam.optimizer.solve_finish = adopt, heavy, finish

    def summary(self) -> dict:
        return {"promotions_adopted": len(self.minted), "minted_per_promotion": self.minted,
                "heavy_boundaries": self.heavy_boundaries, "ba_solves": self.ba_solves}


def run(slam, imgs, depths, on_frame=None) -> dict:
    """Feed every frame to ``slam`` (``track([image], t, depth)``, then
    ``flush()``): the bootstrap from frame 0 (at most BOOT_FRAMES), one
    warm-up chunk, the rest. ``on_frame(phase, i)`` is called before each
    frame of phase ``"boot"``, ``"warm"`` or ``"timed"`` and once with
    ``("flushed", n)``. Returns the bootstrap frame (None without one), the
    landmarks it made, each frame's state and the first timed frame."""
    n = len(imgs)
    states = {}
    cb = on_frame or (lambda phase, i: None)

    def track(i):
        states[i] = slam.track([imgs[i]], timestamp=i * DT, depth=depths[i])["state"]

    i = 0
    while slam.state.name != "OK" and i < min(BOOT_FRAMES, n):
        cb("boot", i)
        track(i)
        i += 1
    if slam.state.name != "OK":
        return {"bootstrap_frame": None, "states": states}
    boot, n_boot = i - 1, slam.map.num_map_points()
    w_end = min(i + max(1, int(slam.config.tracking.chunk_size)), n - 1)  # one warm-up chunk
    for k in range(i, n):
        cb("warm" if k < w_end else "timed", k)
        track(k)
    slam.flush()
    cb("flushed", n)
    return {"bootstrap_frame": boot, "bootstrap_landmarks": n_boot, "states": states, "timed_from": w_end}


def lost_frames(states: dict) -> list[int]:
    return sorted(k for k, s in states.items() if s == "LOST")
