#!/usr/bin/env python3
"""Two-view bootstrap of both packages over seeds of two worlds, on the CPU
(ROADMAP queue 3, Q3.1: chaos or bias in the port's bootstrap?).

    JAX_PLATFORMS=cpu python scripts/q31_bootstrap.py --impl jax --what boot --world tiny --seeds 0-7
    python scripts/q31_bootstrap.py --impl torch --what full --world kitti --seeds 0-3

Worlds: ``tiny`` is tests/test_compiled_slam.py's (``render_sequence``,
17 frames, step 0.3, 320x240, ``small_config``) with the world drawn from
``default_rng(seed)``; ``kitti`` is ``bench.synth_kitti_frames(64,
seed=seed, step=0.6, n_sprites=1500)`` at 376x1240 with
``bench_full_pipeline``'s settings (2000 features, ``min_inliers`` 100).

``--what boot`` feeds frames to ``Initializer.initialize`` (as ``SLAM``
wires it, with the two-view BA) until it succeeds and prints, per seed,
the landmark count, the winning pair's median parallax, the chosen
reference frame and the frame the bootstrap succeeded on. ``--what full``
runs ``CompiledSLAM`` over the whole world (the tiny world in the
self-promoting chunk-of-7 configuration of tests/test_torch_compiled_slam.py,
the kitti world in ``bench_full_pipeline``'s) and prints the scale-aligned
ATE, keyframes and landmarks. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _seeds(text: str) -> list[int]:
    """'0-7,42' -> [0, 1, ..., 7, 42]."""
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def world(name: str, seed: int):
    """(frames, K, T_w2c ground truth)."""
    if name == "tiny":
        from render import render_sequence

        frames, Ts, K, _ = render_sequence(np.random.default_rng(seed), n_frames=17, step=0.3)
        return frames, K, np.stack(Ts)
    import bench

    return bench.synth_kitti_frames(n_frames=64, seed=seed, step=0.6, n_sprites=1500)


def configure(cfg, name: str, what: str):
    """``small_config`` (tiny) or bench_full_pipeline's settings (kitti)."""
    if name == "tiny":
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
        if what == "full":
            cfg.tracking.chunk_size = 7
            cfg.tracking.device_promotion = True
        return cfg
    cfg.feature.num_features = 2000
    cfg.tracking.keyframe_interval = 4
    cfg.initialization.min_inliers = 100
    if what == "full":
        cfg.tracking.chunk_size = 8
        cfg.tracking.device_promotion = True
        cfg.tracking.heavy_boundary_every = 2
        cfg.tracking.upload_f16 = True
        cfg.optimization.max_points = 4096
        cfg.optimization.window_size = 16
        cfg.optimization.pose_bucket_floor = 32
        cfg.optimization.point_bucket_floor = 2048
    return cfg


class _Capture(logging.Handler):
    """Keeps the initializer's success record (points, parallax)."""

    def __init__(self):
        super().__init__()
        self.args = None

    def emit(self, record):
        if record.getMessage().startswith("init: success"):
            self.args = record.args


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--what", choices=("boot", "full"), required=True)
    ap.add_argument("--world", choices=("tiny", "kitti"), required=True)
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--threads", type=int, default=2, help="torch intra-op threads")
    args = ap.parse_args()

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import visual_slam_tpu as pkg
        from visual_slam_tpu.backend.optimizer import LMOptimizer
        from visual_slam_tpu.frontend.tracker import FeatureTracker
        from visual_slam_tpu.models import CompiledSLAM

        kw = {}
    else:
        import torch

        torch.set_num_threads(args.threads)
        import visual_slam_tpu_torch as pkg
        from visual_slam_tpu_torch.backend.optimizer import LMOptimizer
        from visual_slam_tpu_torch.frontend.tracker import FeatureTracker
        from visual_slam_tpu_torch.models import CompiledSLAM

        kw = {"device": "cpu"}
    from importlib import import_module

    Config = import_module(pkg.__name__ + ".config").Config
    PinholeCamera = import_module(pkg.__name__ + ".camera").PinholeCamera
    Initializer = import_module(pkg.__name__ + ".initializer").Initializer
    Map = import_module(pkg.__name__ + ".map").Map
    ate_rmse = import_module(pkg.__name__ + ".utils.metrics").ate_rmse

    for seed in _seeds(args.seeds):
        frames, K, Ts = world(args.world, seed)
        h, w = frames[0].shape
        cam = PinholeCamera(width=w, height=h, K=np.asarray(K, np.float64))
        cfg = configure(Config(), args.world, args.what)
        row = {"impl": args.impl, "what": args.what, "world": args.world, "seed": seed}
        if args.what == "boot":
            m = Map(max_frames=cfg.map.max_frames)
            tracker = FeatureTracker(cfg.feature, **kw)
            log = logging.getLogger(f"q31.{args.impl}.{seed}")
            cap = _Capture()
            log.addHandler(cap)
            log.setLevel(logging.INFO)
            init = Initializer(cam, cfg, tracker, m, logger=log)
            init.optimizer = LMOptimizer(cfg, cam, logger=log, **kw)
            ok_at = None
            for i, img in enumerate(frames[:16]):
                if i == 0:
                    init.add_frame([img], 0.0)
                    continue
                if init.initialize([img], i * 0.1):
                    ok_at = i
                    break
            kfs = m.get_keyframes()
            row.update(ok_frame=ok_at, landmarks=m.num_map_points(),
                       ref_frame=int(round(kfs[0].timestamp / 0.1)) if kfs else None,
                       parallax_deg=float(cap.args[1]) if cap.args else None,
                       n_good=int(cap.args[0]) if cap.args else None,
                       candidates=int(cap.args[2]) if cap.args else None)
        else:
            slam = CompiledSLAM(cam, cfg, **kw)
            lost = 0
            for i, img in enumerate(frames):
                info = slam.track([img], timestamp=i * 0.1)
                lost += info.get("state") == "LOST"
            slam.flush()
            ts, Tw = slam.trajectory()
            idx = [int(round(t / 0.1)) for t in np.asarray(ts)]
            est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in np.asarray(Tw)])
            gt = np.stack([-Ts[j][:3, :3].T @ Ts[j][:3, 3] for j in idx])
            path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
            rmse = float(ate_rmse(est, gt, align_scale=True)["rmse"])
            row.update(state=slam.state.name, lost=lost, keyframes=slam.map.num_keyframes(),
                       landmarks=slam.map.num_map_points(), frames_posed=len(idx), ate_m=rmse,
                       ate_pct=100.0 * rmse / max(path, 1e-9))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
