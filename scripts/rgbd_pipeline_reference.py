#!/usr/bin/env python3
"""RGB-D ``CompiledSLAM`` of either package on tests/rgbd_pipeline_world.py's
worlds: the JAX package or the port on the CPU, the port also on the card.

    JAX_PLATFORMS=cpu python scripts/rgbd_pipeline_reference.py --impl jax
    JAX_PLATFORMS=cpu python scripts/rgbd_pipeline_reference.py --impl jax --keyframe-interval 4
    python scripts/rgbd_pipeline_reference.py --impl torch --threads 1 --world small
    python scripts/rgbd_pipeline_reference.py --impl torch --device cuda --seeds 0 1 2 --dump results/rp

``--world tum`` (the default) runs TUM1's 32 frames at 640x480 and 1000
features in self-promoting chunks of 8 (``--chunk`` sets another size,
``--keyframe-interval`` another interval: at the facades' 4 the JAX
package goes LOST); ``--world small`` runs the 320x240 world through each
route of ``--routes`` (frame by frame, plain chunks of 4, self-promoting
chunks of 4). ``--seeds`` reseeds the tracking step's RANSAC draws per run
(the port's generator, the JAX package's key); ``--perturb`` scales the
images by 1 + eps per run, a change the size of a rounding difference
(negative values as decimals: -0.000001).

One JSON line per run on stdout: the metric ATE (no scale alignment) in
metres and in % of the path, the ATE after a similarity fit and its scale,
keyframes, landmarks, the bootstrap frame and its landmarks, the LOST
frames, the final state, device promotions adopted and the slots each
minted, heavy boundaries, BA solves, and the frames per second over the
timed window (on the CPU a CPU figure, not the card's).
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
    import rgbd_pipeline_world as rpw

    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--world", choices=("tum", "small"), default="tum")
    ap.add_argument("--routes", nargs="+", choices=tuple(rpw.ROUTES), default=list(rpw.ROUTES),
                    help="the small world's routes")
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many frames")
    ap.add_argument("--keyframe-interval", type=int, default=rpw.KF_INTERVAL, help="TUM1's keyframe interval")
    ap.add_argument("--chunk", type=int, default=None, help="TUM1's chunk size")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu, or cuda on a card)")
    ap.add_argument("--perturb", type=float, nargs="+", default=[0.0], help="scale every image by 1 + eps")
    ap.add_argument("--seeds", type=int, nargs="+", default=[None], help="the tracking step's RANSAC seeds")
    ap.add_argument("--dump", default=None, help="write each run's trajectory and keyframe poses here (npz)")
    args = ap.parse_args()

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.models import CompiledSLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        kw = {}
    else:
        import torch

        if args.threads:
            torch.set_num_threads(args.threads)
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.models import CompiledSLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        kw = {"device": args.device}

    t0 = time.perf_counter()
    if args.world == "tum":
        imgs, depths, K, Ts_gt = rpw.tum_frames(args.frames or rpw.N_FRAMES)
    else:
        imgs, depths, K, Ts_gt = rpw.small_frames(args.frames or rpw.SMALL_FRAMES)
    print(f"# rendered {len(imgs)} frames {imgs.shape[1:]} in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    for eps in args.perturb:
        for seed in args.seeds:
            for route in (["tum"] if args.world == "tum" else args.routes):
                if route == "tum":
                    cfg = rpw.tum_config(Config, args.keyframe_interval)
                    cfg.tracking.chunk_size = args.chunk or cfg.tracking.chunk_size
                else:
                    cfg = rpw.small_config(Config, route)
                slam = CompiledSLAM(rpw.camera(PinholeCamera, imgs, K), cfg, **kw)
                if seed is not None:
                    reseed_step(slam, seed)
                line = one_run(args, rpw, slam, ate_rmse, imgs * (1 + eps), depths, Ts_gt,
                               f"{route}_seed{seed}_eps{eps:g}")
                print(json.dumps({"impl": args.impl, "device": kw.get("device", "cpu"), "world": args.world,
                                  "route": route, "chunk": cfg.tracking.chunk_size,
                                  "device_promotion": cfg.tracking.device_promotion,
                                  "keyframe_interval": cfg.tracking.keyframe_interval, "seed": seed, "perturb": eps,
                                  **line}), flush=True)
    return 0


def one_run(args, rpw, slam, ate_rmse, imgs, depths, Ts_gt, tag) -> dict:
    probe = rpw.Probe(slam)
    clock = {}

    def on_frame(phase, i):
        if phase not in clock:
            clock[phase] = (time.perf_counter(), i)

    t0 = time.perf_counter()
    res = rpw.run(slam, imgs, depths, on_frame)
    line = {"frames": len(imgs), "bootstrap_frame": res["bootstrap_frame"]}
    if res["bootstrap_frame"] is not None:
        ts, Ts = slam.trajectory()
        rmse, pct, path = rpw.metric_ate(ate_rmse, ts, Ts, Ts_gt)
        rmse_sim, scale = rpw.scale_fit(ate_rmse, ts, Ts, Ts_gt)
        line.update(ate_rmse_m=rmse, ate_pct_of_path_metric=pct, path_m=path, ate_scale_aligned_m=rmse_sim,
                    fitted_scale=scale, poses=len(ts), bootstrap_landmarks=res["bootstrap_landmarks"])
        if "timed" in clock:
            t_timed, i_timed = clock["timed"]
            line.update(fps_timed=(len(imgs) - i_timed) / (clock["flushed"][0] - t_timed),
                        frames_timed=len(imgs) - i_timed)
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            kfs = slam.map.get_keyframes()
            name = f"{args.impl}_{args.device if args.impl == 'torch' else 'cpu'}_{tag}"
            np.savez(Path(args.dump) / f"{name}.npz", ts=ts, T_w2c=Ts, T_gt=Ts_gt,
                     kf_ts=[kf.timestamp for kf in kfs], kf_T_w2c=np.stack([kf.T_w2c for kf in kfs]))
    line.update(keyframes=slam.map.num_keyframes(), landmarks=slam.map.num_map_points(),
                lost_frames=rpw.lost_frames(res["states"]), final_state=slam.state.name,
                cpu_s=time.perf_counter() - t0, **probe.summary())
    return line


def reseed_step(slam, seed: int) -> None:
    """Reseed the tracking step's draws once the bootstrap has made its
    state (later installs keep them): the port's generator, or the JAX
    package's key."""
    install0 = slam._install_reference

    def install(kf, T_init):
        fresh = slam._track_state is None
        install0(kf, T_init)
        if fresh and hasattr(slam._track_state, "gen"):
            slam._track_state.gen.manual_seed(seed)
        elif fresh:
            import jax

            slam._track_state = slam._track_state._replace(key=jax.random.PRNGKey(seed))

    slam._install_reference = install


if __name__ == "__main__":
    sys.exit(main())
