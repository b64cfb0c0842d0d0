#!/usr/bin/env python3
"""The heavy boundary's two modes beside the default, through either
package's ``CompiledSLAM`` on the CPU, one JSON line per pass:

* ``fp-async``: ``chip_smoke.py``'s full pipeline (bench_full_pipeline's
  world, ``bench.synth_kitti_frames(64, seed=3, step=0.6, n_sprites=1500)``
  at 376x1240, ``chip_smoke.fp_config``) with ``tracking.async_boundary`` on
  at its default gates (``async_boundary_min_kfs`` 12, cooloff 2);
* ``loop-async``: bench_loop_pipeline's 200-frame ring
  (``tests/loop_pipeline_world.py``, loop closing on) with the async
  boundary on;
* ``loop-sparse``: the same ring with ``optimization.sparse_obs="auto"``
  (the sparse landmark-major BA from a pose bucket of 32, so every solve of
  this configuration, whose bucket floor is 32);
* ``fp-lm``: the full pipeline's world and configuration with
  ``optimization.lm_minor=True`` (the JAX package solves it landmark-minor,
  the port on its dense grid);
* ``small-ring-lm``: the small ring (test_compiled_slam_devpromo_loop_closing's
  world, ``tests/loop_pipeline_world.small_ring_frames``, 320x240, 100
  frames, loop closing on) with ``lm_minor=True``.

    JAX_PLATFORMS=cpu python scripts/heavy_modes_reference.py --impl jax
    python scripts/heavy_modes_reference.py --impl torch --passes loop-sparse --frames 72
    JAX_PLATFORMS=cpu python scripts/heavy_modes_reference.py --impl jax --passes fp-lm small-ring-lm

Each line holds the scale-aligned ATE (metres, % of the path), LOST frames,
the final state, keyframes, landmarks, the closures (closing keyframe's
frame), and ``chip_smoke.heavy_counters``' counts (async and sync chunk
boundaries, cooloffs started, landed solves with a device correction and
the largest |s - 1| among them, solves by layout, the layouts of loop
closing's global BA), and the CPU's frames per second over the frames after
the bootstrap (a CPU figure, not the card's). The JAX package's lines are the reference
``chip_smoke.py``'s gates for these passes are set from.
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

PASSES = ("fp-async", "loop-async", "loop-sparse", "fp-lm", "small-ring-lm")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--passes", nargs="+", choices=PASSES, default=list(PASSES))
    ap.add_argument("--frames", type=int, default=None, help="cut the loop world to this many frames")
    args = ap.parse_args()

    import bench
    import chip_smoke as cs
    import loop_pipeline_world as lpw

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.models import CompiledSLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        kw = {}
    else:
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.models import CompiledSLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        kw = {"device": "cpu"}

    for name in args.passes:
        t0 = time.perf_counter()
        if name.startswith("fp-"):
            frames, K, T_gt = bench.synth_kitti_frames(n_frames=cs.FP_FRAMES, H=cs.H, W=cs.W, f=cs.FOCAL,
                                                       n_sprites=cs.FP_SPRITES, seed=cs.FP_SEED, step=cs.FP_STEP)
            cfg = cs.fp_config(Config)
        elif name.startswith("small-ring"):
            frames, K, T_gt = lpw.small_ring_frames(args.frames or 100)
            cfg = lpw.small_ring_config(Config)
        else:
            frames, K, T_gt = lpw.loop_frames(args.frames or lpw.N_FRAMES)
            cfg = lpw.loop_config(Config, True)
        if name.endswith("async"):
            cfg.tracking.async_boundary = True
        elif name.endswith("sparse"):
            cfg.optimization.sparse_obs = "auto"
        else:
            cfg.optimization.lm_minor = True
        print(f"# {name}: rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        h, w = frames[0].shape
        slam = CompiledSLAM(PinholeCamera(width=w, height=h, K=np.asarray(K, np.float64)), cfg, **kw)
        counts = cs.heavy_counters(slam)
        closures = []
        if slam.loop_closing is not None:
            close0 = slam.loop_closing.close

            def close(kf, *a, close0=close0, **k):
                closures.append(int(round(kf.timestamp / 0.1)))
                return close0(kf, *a, **k)

            slam.loop_closing.close = close
        states, boot = [], None
        t_clock = None
        for i, img in enumerate(frames):
            states.append(slam.track([img], timestamp=i * 0.1).get("state"))
            if boot is None and slam.state.name == "OK":
                boot, t_clock = i, time.perf_counter()
        slam.flush()
        wall = time.perf_counter() - t_clock
        ts, Tw = slam.trajectory()
        rmse, pct = lpw.ate_pct(ate_rmse, np.asarray(ts), np.asarray(Tw), T_gt)
        print(json.dumps(dict(impl=args.impl, run=name, frames=len(frames), bootstrap_frame=boot, ate_m=rmse,
                              ate_pct=pct, lost_frames=states.count("LOST"), state=slam.state.name,
                              keyframes=slam.map.num_keyframes(), landmarks=slam.map.num_map_points(), poses=len(ts),
                              cpu_fps=(len(frames) - boot - 1) / wall, closures=closures, **cs.heavy_summary(counts))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
