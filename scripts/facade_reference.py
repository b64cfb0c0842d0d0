#!/usr/bin/env python3
"""The host SLAM facade (``SLAM``) of either package on the CPU, over the
worlds of ``chip_smoke.py``'s facade phases (``tests/facade_world.py``).
Prints one JSON line per run.

    JAX_PLATFORMS=cpu python scripts/facade_reference.py --impl jax --world deploy
    python scripts/facade_reference.py --impl torch --world endurance --loop on
    python scripts/facade_reference.py --impl torch --world deploy --threaded
    python scripts/facade_reference.py --impl torch --world e2e --threaded --reps 10
    python scripts/facade_reference.py --impl torch --world deploy --seeds 0 1 2 --trace
    python scripts/facade_reference.py --impl jax --world deploy --frames 32 --solver adam --perturb 0 0.000001

The JAX package's figures are the reference that ``chip_smoke.py``'s facade
gates are set from; the port's CPU run is a rehearsal of the same phase
(the kernels' plain versions run in place of the kernels).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--world", choices=("deploy", "endurance", "e2e"), required=True)
    ap.add_argument("--loop", choices=("on", "off"), default="off")
    ap.add_argument("--threaded", action="store_true")
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many frames")
    ap.add_argument("--reps", type=int, default=1, help="runs of the same world, one JSON line each")
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="reseed the tracker's RANSAC (13 by default) for each run, one JSON line per seed and rep")
    ap.add_argument("--trace", action="store_true",
                    help="add each frame's guided / 3D-2D pairs / PnP inliers ('K': a new keyframe) to the line")
    ap.add_argument("--solver", choices=("lm_schur", "adam"), default="lm_schur", help="optimization.solver")
    ap.add_argument("--perturb", type=float, nargs="*", default=[0.0],
                    help="scale the images by 1 + eps (a rounding-sized change), one run per eps")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads (the port only)")
    args = ap.parse_args()

    import numpy as np

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
        if args.threads:
            import torch

            torch.set_num_threads(args.threads)

    if args.world == "deploy":
        frames, K, Ts = fw.deploy_frames(args.frames or 64)
        cfg = fw.deploy_config(Config)
    elif args.world == "e2e":
        frames, K, Ts = fw.e2e_frames(args.frames or 12)
        cfg = fw.e2e_config(Config)
    else:
        frames, K, Ts = fw.endurance_frames(args.frames or 200)
        cfg = fw.endurance_config(Config, args.loop == "on")
    cfg.optimization.solver = args.solver

    def reseed(slam, seed):
        if args.impl == "jax":
            slam.tracking._key = jax.random.PRNGKey(seed)
        else:
            slam.tracking._gen.manual_seed(seed)

    h, w = frames[0].shape
    runs = [(r, s, e) for r in range(args.reps) for s in (args.seeds or [None]) for e in args.perturb]
    for rep, seed, eps in runs:
        t0 = time.perf_counter()
        slam = SLAM(PinholeCamera(width=w, height=h, K=K), cfg, threaded=args.threaded, **kw)
        if seed is not None:
            reseed(slam, seed)
        trace = []
        imgs = frames if eps == 0.0 else [f * np.float32(1.0 + eps) for f in frames]
        res = fw.run(slam, imgs, on_frame=lambda i, info: trace.append(fw.trace_entry(i, info)))
        t1 = time.perf_counter()
        slam.shutdown()
        out = fw.summary(slam, res, Ts, ate_rmse)
        out.update(impl=args.impl, world=args.world, loop=args.loop, threaded=args.threaded, frames=len(frames),
                   rep=rep, ransac_seed=13 if seed is None else seed, solver=type(slam.optimizer).__name__,
                   perturb=eps, shutdown_s=time.perf_counter() - t1, total_s=time.perf_counter() - t0)
        if slam.loop_closing is not None:
            out["closed_loops"] = [list(p) for p in slam.loop_closing.closed_loops]
            out["funnel"] = slam.loop_closing.funnel
        if args.trace:
            out["trace"] = " ".join(trace)
        print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
