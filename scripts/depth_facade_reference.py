#!/usr/bin/env python3
"""The stereo and RGB-D host facade (``SLAM``) of either package on the CPU,
over the worlds of ``chip_smoke.py``'s stereo and RGB-D phases
(``tests/depth_world.py``), and the threaded mono deployment world of its
threaded phase (``tests/facade_world.py``). Prints one JSON line per run.

    JAX_PLATFORMS=cpu python scripts/depth_facade_reference.py --impl jax --world stereo --seeds -1 0 1 2 3
    JAX_PLATFORMS=cpu python scripts/depth_facade_reference.py --impl jax --world rgbd --fused
    JAX_PLATFORMS=cpu python scripts/depth_facade_reference.py --impl jax --world deploy-threaded --reps 8
    python scripts/depth_facade_reference.py --impl torch --world stereo --frames 12

Seed -1 keeps the tracker's default RANSAC seed (13). Each run is classed
as ``chip_smoke.py`` classes it: LOST (a LOST frame after the bootstrap),
scale jump (keyframe ATE above 5 % of the path: metric, without scale
alignment, on the depth worlds; scale-aligned on the mono deployment world)
or clean. The JAX package's lines are the reference that the script's
gates are set from; the port's CPU run rehearses the same phase (the
kernels' plain versions run in place of the kernels).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

JUMP_PCT = 5.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--world", choices=("stereo", "rgbd", "deploy-threaded"), required=True)
    ap.add_argument("--fused", action="store_true", help="tracking.fused_pipeline (the one-step frame)")
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many frames")
    ap.add_argument("--reps", type=int, default=1, help="runs of the same world and seed, one JSON line each")
    ap.add_argument("--seeds", type=int, nargs="*", default=[-1],
                    help="the tracker's RANSAC seed of each run; -1 keeps its default (13)")
    args = ap.parse_args()

    import depth_world as dw
    import facade_world as fw

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.slam import SLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        kw = {}
    else:
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.slam import SLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        kw = {"device": "cpu"}

    def reseed(slam, seed):
        if args.impl == "jax":
            slam.tracking._key = jax.random.PRNGKey(seed)
        else:
            slam.tracking._gen.manual_seed(seed)

    threaded = args.world == "deploy-threaded"
    if threaded:
        frames, K, Ts = fw.deploy_frames(args.frames or 64)
        cfg, baseline, sensor = fw.deploy_config(Config), 0.0, "monocular"
        seq = (frames, None)
    elif args.world == "stereo":
        lefts, rights, K, Ts = dw.stereo_frames(args.frames or 48)
        cfg, baseline, sensor = dw.stereo_config(Config), dw.STEREO_BASELINE, "stereo"
        seq = (lefts, rights)
    else:
        imgs, depths, K, Ts = dw.rgbd_frames(args.frames or 32)
        cfg, baseline, sensor = dw.rgbd_config(Config), 0.0, "rgbd"
        seq = (imgs, depths)
    cfg.tracking.fused_pipeline = args.fused
    h, w = seq[0][0].shape
    for rep, seed in [(r, s) for r in range(args.reps) for s in args.seeds]:
        t0 = time.perf_counter()
        slam = SLAM(PinholeCamera(width=w, height=h, K=np.asarray(K, np.float64), baseline=baseline), cfg,
                    threaded=threaded, **kw)
        if seed >= 0:
            reseed(slam, seed)
        states, shares, relocs = [], [], 0
        boot, t_boot = None, None
        for i in range(len(seq[0])):
            images, depth = ([seq[0][i]], None) if threaded else dw.track_args(sensor, seq, i)
            info = slam.track(images, timestamp=i * dw.DT, depth=depth)
            states.append(info["state"])
            relocs += bool(info.get("relocalized"))
            if info["state"] == "OK":
                if boot is None:
                    boot, t_boot = i, time.perf_counter()
                share = dw.kp_z_share(slam.tracking.current_frame)
                if share is not None and i > boot:
                    shares.append(share)
        secs = time.perf_counter() - t_boot if t_boot is not None else 0.0
        t1 = time.perf_counter()
        slam.shutdown()
        shutdown_s = time.perf_counter() - t1
        boot = len(states) if boot is None else boot
        lost = sum(s == "LOST" for s in states[boot:])
        out = {"impl": args.impl, "world": args.world, "fused": args.fused, "frames": len(states), "rep": rep,
               "ransac_seed": 13 if seed < 0 else seed, "state": slam.state.name, "boot_frame": boot,
               "lost_after_boot": lost, "relocalizations": relocs, "keyframes": slam.map.num_keyframes(),
               "landmarks": slam.map.num_map_points()}
        if threaded:
            ate = fw.summary(slam, {"states": states, "relocs": relocs, "poses": [], "boot": boot,
                                    "secs_after_boot": secs}, Ts, ate_rmse).get("ate_keyframes")
            out["ate_keyframes"] = ate
            out["outcome"] = ("LOST" if lost or slam.state.name != "OK" else
                              "scale jump" if ate is None or ate["pct"] > JUMP_PCT else "clean")
        else:
            ate = dw.metric_ate(slam, Ts, ate_rmse)
            out["ate_keyframes_metric"] = ate
            out["outcome"] = dw.classify(lost, ate, JUMP_PCT)
            out["kp_z_valid_frac"] = float(np.mean(shares)) if shares else None
        out.update(fps_after_boot=(len(states) - boot - 1) / secs if secs > 0 else 0.0, shutdown_s=shutdown_s,
                   total_s=time.perf_counter() - t0)
        print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
