#!/usr/bin/env python3
"""``bench_stereo_step``'s world (tests/stereo_step_world.py: 12 KITTI-width
stereo pairs, 2000 features) through either package's stereo tracking step
on the CPU, as bench.py runs it:

1. the step on pair 0 from a state around frame 0's own features; its
   depths give ``stereo_kp_z_valid_frac`` (the mean over all slots of
   kp_z_valid & features.valid) and, backprojected (20 m where a slot has
   none), frame 0's landmarks;
2. the step on pair 1 from a state holding those landmarks:
   ``stereo_n_inliers`` and the pose against ground truth;
3. ``--steps`` steps cycled over pairs 1-11 and one value fetch: the CPU's
   steps per second (a CPU figure, not a device's).

It also prints the depth funnel on pair 0 (valid left keypoints; with a
right candidate inside the row and disparity gate; passing the ratio test;
the cross-check; z > min_depth), re-done in numpy from the step's own left
and right features and held against its ``kp_z_valid``, and what the
world's geometry allows for those keypoints (``depth_geometry``).

    JAX_PLATFORMS=cpu python scripts/stereo_step_reference.py --impl jax
    python scripts/stereo_step_reference.py --impl torch --steps 6

One JSON line on stdout. The JAX package's line is the reference
``chip_smoke.py``'s stereo step gates are set from.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--steps", type=int, default=None, help="timed steps (default: bench's 60)")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    args = ap.parse_args()

    import stereo_step_world as ssw

    pairs, K, Ts = ssw.bench_world()
    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from visual_slam_tpu.ops.detector import detect_and_describe
        from visual_slam_tpu.pipeline import init_track_state, make_track_step

        step = make_track_step(jnp.asarray(K), **ssw.step_kwargs())

        def detect(img):
            return detect_and_describe(jnp.asarray(img), num_features=ssw.N_FEATURES, threshold=20.0,
                                       n_levels=ssw.N_LEVELS)

        def pair_features(pair):
            return detect(pair[0]), detect(pair[1])

        def init(feats, lm, has):
            return init_track_state(feats, lm, has, np.eye(4), seed=0)

        def run(state, pair):
            return step(state, jnp.asarray(pair))

        def npy(x):
            return np.asarray(x)

        def desc(f):
            return np.asarray(f.desc)
    else:
        import torch

        if args.threads:
            torch.set_num_threads(args.threads)
        from visual_slam_tpu_torch import pipeline

        step = pipeline.make_track_step(K, device="cpu", **ssw.step_kwargs())

        def detect(img):
            return step.detect(torch.from_numpy(img))

        def pair_features(pair):
            return step.detect_pair(torch.from_numpy(pair))

        def init(feats, lm, has):
            return pipeline.init_track_state(feats, lm, has, np.eye(4), seed=0, device="cpu")

        def run(state, pair):
            return step(state, torch.from_numpy(pair))

        def npy(x):
            return x.numpy()

        def desc(f):
            return f.desc.numpy()

    t0 = time.perf_counter()
    feats0 = detect(pairs[0, 0])
    _, out0 = run(init(feats0, np.zeros((ssw.N_FEATURES, 3), np.float32), npy(feats0.valid)), pairs[0])
    xy0, z0 = npy(out0.features.xy), npy(out0.kp_z)
    z_ok = npy(out0.kp_z_valid) & npy(out0.features.valid)
    first_s = time.perf_counter() - t0

    fl, fr = pair_features(pairs[0])
    bf = ssw.BASELINE * float(K[0, 0])
    funnel = ssw.depth_funnel(npy(fl.xy), desc(fl), npy(fl.valid), npy(fr.xy), desc(fr), npy(fr.valid), bf)
    slots = funnel.pop("valid_slots")
    funnel_vs_step = int((slots != z_ok).sum())
    geometry = ssw.depth_geometry(npy(fl.xy), npy(fl.valid), left_image=pairs[0, 0])

    lm, has = ssw.landmarks_from_depths(K, xy0, z0, z_ok)
    state = init(feats0, lm, has)
    _, out1 = run(state, pairs[1])
    T1 = npy(out1.T_w2c)

    n = args.steps if args.steps is not None else ssw.N_STEPS
    s, out = state, out1
    t0 = time.perf_counter()
    for i in range(n):
        s, out = run(s, pairs[1 + i % (len(pairs) - 1)])
    float(npy(out.T_w2c)[0, 0])
    cpu_fps = n / (time.perf_counter() - t0) if n else None

    print(json.dumps({
        "impl": args.impl,
        "stereo_kp_z_valid_frac": float(z_ok.mean()),
        "stereo_n_inliers": int(npy(out1.n_inliers)),
        "pair1_t": T1[:3, 3].tolist(),
        "pair1_t_err_m": float(np.linalg.norm(T1[:3, 3] - Ts[1][:3, 3])),
        "pair1_R_err": float(np.abs(T1[:3, :3] - Ts[1][:3, :3]).max()),
        "pair0_depth_valid_slots": int(z_ok.sum()),
        "funnel_pair0": funnel,
        "funnel_vs_step_mismatches": funnel_vs_step,
        "geometry_pair0": geometry,
        "cpu_steps": n,
        "cpu_fps": cpu_fps,
        "first_step_s": first_s,
    }), flush=True)
    if funnel_vs_step:
        print(f"the funnel's depth-valid slots differ from the step's on {funnel_vs_step} slots", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
