#!/usr/bin/env python3
"""``bench_loop_pipeline``'s world (``tests/loop_pipeline_world.py``: a
200-frame KITTI-width ring revisit with noise and brightness drift) through
``CompiledSLAM`` of either package on the CPU, in three passes, one JSON
line each:

1. ``on``: loop closing on; the pass saves a checkpoint after the chunk
   that ends at ``--checkpoint`` (then ``flush()``) and goes on tracking;
2. ``off``: loop closing off;
3. ``resume``: a new system resumed from the ``on`` pass's checkpoint (the
   id counters first reset to 0, as in a new process) tracks the frames
   after it; its ATE covers the whole trajectory, the restored blocks and
   the resumed frames.

    JAX_PLATFORMS=cpu python scripts/loop_pipeline_reference.py --impl jax
    python scripts/loop_pipeline_reference.py --impl torch --passes on --frames 64

Each line holds the scale-aligned ATE in metres and in % of the path, the
closures (keyframe ids and the frame of the closing keyframe), keyframes,
landmarks, LOST frames, the final state and the CPU's frames per second
after bootstrap and warm-up (a CPU figure, not the card's). The JAX
package's lines are the reference ``chip_smoke.py``'s loop gates are set
from; the port's CPU run rehearses the same phase through the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--passes", nargs="+", choices=("on", "off", "resume"), default=["on", "off", "resume"])
    ap.add_argument("--checkpoint", type=int, default=103, help="the last frame tracked before the save")
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many frames")
    ap.add_argument("--out", default=None, help="keep the checkpoint in this directory")
    args = ap.parse_args()

    import loop_pipeline_world as lpw

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.map import KeyFrame
        from visual_slam_tpu.map.frame import FrameBase
        from visual_slam_tpu.models import CompiledSLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        kw = {}
    else:
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.map import KeyFrame
        from visual_slam_tpu_torch.map.frame import FrameBase
        from visual_slam_tpu_torch.models import CompiledSLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        kw = {"device": "cpu"}

    t0 = time.perf_counter()
    n = args.frames or lpw.N_FRAMES
    frames, K, T_gt = lpw.loop_frames(n)
    print(f"# rendered {n} frames {frames.shape[1:]} in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    cam = PinholeCamera(width=lpw.WIDTH, height=lpw.HEIGHT, K=K)
    ckpt_dir = Path(args.out) if args.out else Path(tempfile.mkdtemp(prefix="loop_ckpt_"))

    def watch(slam, closures):
        """Record each closure (the closing keyframe's id and frame)."""
        lc = slam.loop_closing
        if lc is None:
            return
        close0 = lc.close

        def close(kf, det, *a, **k):
            res = close0(kf, det, *a, **k)
            closures.append({"kf": int(kf.keyframe_id), "candidate": int(det["candidate"].keyframe_id),
                             "frame": int(round(kf.timestamp / lpw.DT)), "n_inliers": int(det["n_inliers"])})
            return res

        lc.close = close

    def track(slam, k, states):
        states.append(slam.track([frames[k]], timestamp=k * lpw.DT).get("state"))

    def finish(name, slam, states, closures, t_clock, n_timed, extra=None):
        slam.flush()
        wall = time.perf_counter() - t_clock
        ts, Tw = slam.trajectory()
        rmse, pct = lpw.ate_pct(ate_rmse, ts, Tw, T_gt)
        line = {"impl": args.impl, "pass": name, "frames": n, "ate_m": rmse, "ate_pct": pct,
                "closures": closures, "keyframes": slam.map.num_keyframes(), "landmarks": slam.map.num_map_points(),
                "lost_frames": states.count("LOST"), "state": slam.state.name, "poses": len(ts),
                "cpu_fps": n_timed / wall if n_timed else None}
        line.update(extra or {})
        print(json.dumps(line), flush=True)
        return line

    def run(loop_on: bool, save_at=None):
        name = "on" if loop_on else "off"
        slam = CompiledSLAM(cam, lpw.loop_config(Config, loop_on), **kw)
        closures, states = [], []
        watch(slam, closures)
        i = 0
        while slam.state.name != "OK" and i < 16:
            track(slam, i, states)
            i += 1
        if slam.state.name != "OK":
            raise SystemExit(f"{name}: bootstrap failed after {i} frames")
        boot = i - 1
        w_end = lpw.warm_end(i, n)
        while i < w_end:
            track(slam, i, states)
            i += 1
        extra = {"bootstrap_frame": boot, "timed_from": w_end}
        t_clock, n_timed = time.perf_counter(), 0
        for k in range(i, n):
            track(slam, k, states)
            n_timed += 1
            if k == save_at:
                slam.flush()
                ts = time.perf_counter()
                slam.save(ckpt_dir)
                save_s = time.perf_counter() - ts
                t_clock += save_s  # the clock leaves the save out
                extra.update(checkpoint_frame=k, save_s=save_s,
                             checkpoint_bytes=sum(p.stat().st_size for p in ckpt_dir.iterdir()),
                             closures_before_checkpoint=len(closures), saved_keyframes=slam.map.num_keyframes(),
                             saved_landmarks=slam.map.num_map_points(), chunk_end=not slam._chunk_buf)
        return finish(name, slam, states, closures, t_clock, n_timed, extra)

    for name in args.passes:
        if name == "on":
            run(True, save_at=args.checkpoint if "resume" in args.passes else None)
        elif name == "off":
            run(False)
        else:
            if not (ckpt_dir / "slam.json").exists():
                raise SystemExit(f"no checkpoint in {ckpt_dir}: run the 'on' pass first or pass --out")
            # A new process: the id counters restart at 0.
            with FrameBase._ids_lock:
                FrameBase._ids = itertools.count(0)
            with KeyFrame._kf_ids_lock:
                KeyFrame._kf_ids = itertools.count(0)
            t = time.perf_counter()
            slam = CompiledSLAM.resume(ckpt_dir, cam, **kw)
            resume_s = time.perf_counter() - t
            restored = {"restored_keyframes": slam.map.num_keyframes(), "restored_landmarks": slam.map.num_map_points()}
            closures, states = [], []
            watch(slam, closures)
            start = int(round(max(slam.trajectory()[0]) / lpw.DT)) + 1
            t_clock = time.perf_counter()
            for k in range(start, n):
                track(slam, k, states)
            finish("resume", slam, states, closures, t_clock, n - start,
                   dict(restored, resumed_from=start, resume_s=resume_s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
