"""Self-contained visual-odometry demo of the PyTorch port on a synthetic
rendered world: the port's counterpart of
``examples/visual_odometry_demo.py``.

  python examples/visual_odometry_demo_torch.py [--cpu]

Runs on the CUDA card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from render import render_sequence  # noqa: E402  (tests/render.py synthetic world)

from visual_slam_tpu_torch.camera import PinholeCamera  # noqa: E402
from visual_slam_tpu_torch.config import Config  # noqa: E402
from visual_slam_tpu_torch.slam import SLAM  # noqa: E402
from visual_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_keyframes  # noqa: E402
from visual_slam_tpu_torch.utils.profiling import StageTimer  # noqa: E402


def main(argv=None, on_frame=None) -> dict:
    """Track the world and print each frame, the ATE and the stage timings.
    ``on_frame(i, slam)`` runs after each frame. Returns the ATE (``ate``:
    ``ate_rmse``'s result, in world units), the timer's summary
    (``timing``), the keyframe and landmark counts and each frame's state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=20, step=0.3)

    cfg = Config()
    cfg.feature.num_features = 512
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.optimization.window_size = 10

    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    slam = SLAM(cam, cfg, device="cpu" if args.cpu else None)
    timer = StageTimer()
    states = []
    for i, img in enumerate(frames):
        with timer("track"):
            info = slam.track([img], timestamp=i * 0.1)
        states.append(info["state"])
        print(f"frame {i:3d} state={info['state']:<14} "
              f"inliers={info.get('n_inliers', '-')}")
        if on_frame is not None:
            on_frame(i, slam)
    slam.shutdown()

    kfs = slam.map.get_keyframes()
    print(f"\nkeyframes: {len(kfs)}  landmarks: {slam.map.num_map_points()}")
    est = trajectory_from_keyframes(kfs)
    idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt)
    print(f"ATE RMSE (Sim3-aligned): {res['rmse']:.4f} world units")
    print("\nper-stage timing:\n" + timer.report())
    return {"ate": res, "timing": timer.summary(), "keyframes": len(kfs),
            "landmarks": slam.map.num_map_points(), "states": states}


if __name__ == "__main__":
    main()
