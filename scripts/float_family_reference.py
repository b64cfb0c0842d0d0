#!/usr/bin/env python3
"""The host SLAM facade (``SLAM``) of either package on the CPU, over the
feature families of ``chip_smoke.py``'s feature-family phase: the deploy
world's first 32 frames (``tests/facade_world.py``: FAMILY_FRAMES,
FAMILIES) with DoG SIFT + L2, GradHist + L2 and Shi-Tomasi ORB + Hamming,
each at its RANSAC seeds, or (``--world e2e``) tests/test_float_family_slam.py's
world and ``sift_config`` with the family's detector and matcher. Prints one JSON line per run, then one per
family: its failed runs (LOST after the bootstrap, or a keyframe ATE above
``--jump-pct`` % of the path; on the e2e world, a run that fails that
test's assertions) and the median keyframe ATE of its clean runs.

    JAX_PLATFORMS=cpu python scripts/float_family_reference.py --impl jax
    python scripts/float_family_reference.py --impl torch --threads 1
    python scripts/float_family_reference.py --impl jax --families sift --seeds 13 0 --trace
    JAX_PLATFORMS=cpu python scripts/float_family_reference.py --impl jax --world e2e --families shi_tomasi_orb

The JAX package's figures are the reference that ``chip_smoke.py``'s
FF_JAX gates are set from; the port's CPU run is a rehearsal of the phase.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import facade_world as fw

    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--families", nargs="*", default=list(fw.FAMILIES), choices=list(fw.FAMILIES))
    ap.add_argument("--seeds", type=int, nargs="*", default=None, help="RANSAC seeds (each family's own by default)")
    ap.add_argument("--world", choices=("deploy", "e2e"), default="deploy",
                    help="e2e: tests/test_float_family_slam.py's world and sift_config with the family's detector")
    ap.add_argument("--frames", type=int, default=None, help="frames of the world (FAMILY_FRAMES, or 10 for e2e)")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--jump-pct", type=float, default=5.0, help="keyframe ATE (%% of path) that classes a run failed")
    ap.add_argument("--trace", action="store_true",
                    help="add each frame's guided / 3D-2D pairs / PnP inliers ('K': a new keyframe) to the line")
    args = ap.parse_args()

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.slam import SLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        kw = {}

        def reseed(slam, seed):
            slam.tracking._key = jax.random.PRNGKey(seed)
    else:
        import torch

        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.slam import SLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        if args.threads:
            torch.set_num_threads(args.threads)
        kw = {"device": "cpu"}

        def reseed(slam, seed):
            slam.tracking._gen.manual_seed(seed)

    if args.world == "deploy":
        frames, K, Ts = fw.deploy_frames(args.frames or fw.FAMILY_FRAMES)
        config = fw.family_config
    else:
        frames, K, Ts = fw.e2e_frames(args.frames or 10)
        config = fw.sift_config
    h, w = frames[0].shape
    for family in args.families:
        runs = []
        for seed in args.seeds or fw.FAMILIES[family][3]:
            t0 = time.perf_counter()
            slam = SLAM(PinholeCamera(width=w, height=h, K=K), config(Config, family), **kw)
            reseed(slam, seed)
            trace = []
            res = fw.run(slam, frames, on_frame=lambda i, info: trace.append(fw.trace_entry(i, info)))
            slam.shutdown()
            out = fw.summary(slam, res, Ts, ate_rmse)
            kf_pct = out.get("ate_keyframes", {}).get("pct", float("inf"))
            widths = sorted({int(mp.descriptor.size) for mp in slam.map.get_map_points() if mp.descriptor is not None})
            if args.world == "e2e":  # tests/test_float_family_slam.py's assertions
                ok = (res["states"][-2:] == ["OK", "OK"] and out["keyframes"] >= 3 and out["landmarks"] > 50
                      and widths == [slam.feature_tracker.desc_words])
                outcome = "clean" if ok else "failed the e2e assertions"
            else:
                outcome = "LOST" if out["lost_after_boot"] else "scale jump" if kf_pct > args.jump_pct else "clean"
            out.update(impl=args.impl, world=args.world, family=family, ransac_seed=seed, frames=len(frames),
                       last_states=res["states"][-2:], desc_widths=widths, outcome=outcome,
                       total_s=time.perf_counter() - t0)
            if args.trace:
                out["trace"] = " ".join(trace)
            print(json.dumps(out, default=str), flush=True)
            runs.append(out)
        clean = [r["ate_keyframes"]["pct"] for r in runs if r["outcome"] == "clean"]
        print(json.dumps({"impl": args.impl, "family": family, "seeds": [r["ransac_seed"] for r in runs],
                          "outcomes": [r["outcome"] for r in runs],
                          "failed": sum(r["outcome"] != "clean" for r in runs),
                          "median_clean_ate_keyframes_pct": statistics.median(clean) if clean else None,
                          "boot_frames": [r["boot_frame"] for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
