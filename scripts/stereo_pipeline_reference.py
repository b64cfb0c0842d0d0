#!/usr/bin/env python3
"""``bench_stereo_pipeline``'s world and run (``tests/stereo_pipeline_world.py``:
48 KITTI-width stereo pairs, 2000 features, self-promoting chunks of 8)
through stereo ``CompiledSLAM`` of either package on the CPU, as bench.py
runs it: a bootstrap within the first 6 pairs, a warm-up through two heavy
cycles, a timed window that ends on a chunk boundary, then ``flush()``.

    JAX_PLATFORMS=cpu python scripts/stereo_pipeline_reference.py --impl jax
    python scripts/stereo_pipeline_reference.py --impl torch --threads 1
    python scripts/stereo_pipeline_reference.py --impl torch --device cuda --seeds 0 1 2 --dump results/sp
    python scripts/stereo_pipeline_reference.py --impl torch --world plain --seeds 0 1 2

``--seeds`` reseeds the tracking step's RANSAC draws per run (the port's
generator, the JAX package's key); ``--perturb`` scales the bench world's
images by 1 + eps per run, a change the size of a rounding difference. ``--world single|promotion|plain`` runs
one of the JAX package's stereo ``CompiledSLAM`` test worlds instead
(320x240; every pair tracked, then ``shutdown()``; no clock),
``--world-seeds`` redrawing the world's sprites and ``--chunk`` setting
another chunk size.

One JSON line on stdout: ``stereo_pipeline_fps`` (the CPU's frames per
second over the timed window, a CPU figure, not the card's),
``stereo_pipeline_ate_pct_of_path_metric`` (no scale alignment), the
metric ATE in metres, the ATE after a similarity fit and its scale, each
keyframe's camera-centre error, keyframes, landmarks, the pair that bootstrapped,
the LOST pairs, the final state, and ``stereo_pipeline_world.Probe``'s
counts (device-minted slots per promotion, double mints, BA solves over
the landmark cap, the largest map). The JAX package's line is the
reference ``chip_smoke.py``'s stereo pipeline gates are set from.

With ``--dump`` the line also carries ``pairs``, pairs 13-16 as the
self-promoting chunk tracked them (``stereo_pipeline_world.ChunkTrace``):
the PnP inliers, the reference-block matches, the guided pairs, the
landmarks of the reference block each pair tracked against, the valid
arena slots, the promotion and its minted slots, and the camera-centre
error of the tracked pose; the npz beside it holds every pair's row and,
for the chunk holding pair 16, the reference block and the arena as the
chunk received them.
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
    import stereo_pipeline_world as spw

    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many pairs")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu, or cuda on a card)")
    ap.add_argument("--perturb", type=float, nargs="+", default=[0.0],
                    help="scale every image by 1 + eps (bench world): a rounding-sized change of the input")
    ap.add_argument("--dump", default=None, help="write each run's trajectory and keyframe poses here (npz)")
    ap.add_argument("--world", choices=("bench", *spw.SMALL), default="bench")
    ap.add_argument("--seeds", type=int, nargs="+", default=[None], help="the tracking step's RANSAC seeds")
    ap.add_argument("--world-seeds", type=int, nargs="+", default=[None], help="the sprites' seeds (small worlds)")
    ap.add_argument("--chunk", type=int, default=None, help="chunk size (small worlds)")
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

    if args.world != "bench":
        return small_runs(args, spw, CompiledSLAM, PinholeCamera, Config, ate_rmse, kw)
    t0 = time.perf_counter()
    lefts, rights, K, Ts_gt = spw.stereo_frames(args.frames or spw.N_FRAMES)
    print(f"# rendered {len(lefts)} pairs {lefts.shape[1:]} in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    for eps in args.perturb:
        for seed in args.seeds:
            bench_run(args, spw, CompiledSLAM, PinholeCamera, Config, ate_rmse, kw, lefts * (1 + eps),
                      rights * (1 + eps), K, Ts_gt, seed, eps)
    return 0


def bench_run(args, spw, CompiledSLAM, PinholeCamera, Config, ate_rmse, kw, lefts, rights, K, Ts_gt, seed,
              eps) -> None:
    """bench_stereo_pipeline's run; one JSON line."""
    n = len(lefts)
    slam = CompiledSLAM(spw.camera(PinholeCamera, lefts, K), spw.config(Config), **kw)
    if seed is not None:
        reseed_step(slam, seed)
    probe = spw.Probe(slam)
    trace = spw.ChunkTrace(slam, Ts_gt) if args.dump else None
    states = {}

    def track(k):
        if trace is not None:
            trace.pair = k
        states[k] = slam.track([lefts[k], rights[k]], timestamp=k * spw.DT)["state"]

    t0 = time.perf_counter()
    i = 0
    while slam.state.name != "OK" and i < spw.BOOT_FRAMES:
        track(i)
        i += 1
    boot = i - 1
    line = {"impl": args.impl, "frames": n, "seed": seed, "perturb": eps,
            "bootstrap_frame": boot if slam.state.name == "OK" else None}
    if slam.state.name == "OK":
        warm_end, n_end = spw.schedule(i, n)
        while i < warm_end:
            track(i)
            i += 1
        print(f"# bootstrap on pair {boot}, warm-up to pair {warm_end - 1} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        for k in range(i, n_end):
            track(k)
        slam.flush()
        fps = (n_end - i) / (time.perf_counter() - t0)
        ts, Ts = slam.trajectory()
        rmse, pct, path = spw.metric_ate(ate_rmse, ts, Ts, Ts_gt)
        rmse_sim, scale = spw.scale_fit(ate_rmse, ts, Ts, Ts_gt)
        kf_err = spw.keyframe_errors(slam.map.get_keyframes(), Ts_gt)
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            kfs = slam.map.get_keyframes()
            np.savez(Path(args.dump) / f"{args.impl}_{args.device if args.impl == 'torch' else 'cpu'}_seed{seed}.npz",
                     ts=ts, T_w2c=Ts, T_gt=Ts_gt, kf_ts=[kf.timestamp for kf in kfs],
                     kf_T_w2c=np.stack([kf.T_w2c for kf in kfs]), pair_rows=json.dumps(trace.rows),
                     **trace.blocks)
            line["pairs"] = {k: trace.rows[k] for k in spw.F7_PAIRS if k in trace.rows}
        line.update(stereo_pipeline_fps=fps, stereo_pipeline_ate_pct_of_path_metric=pct, ate_rmse_m=rmse,
                    path_m=path, ate_scale_aligned_m=rmse_sim, fitted_scale=scale, frames_timed=n_end - i,
                    poses=len(ts), keyframe_centre_err_m=kf_err)
    line.update(keyframes=slam.map.num_keyframes(), landmarks=slam.map.num_map_points(),
                lost_frames=sorted(k for k, s in states.items() if s == "LOST"), final_state=slam.state.name,
                **probe.summary())
    print(json.dumps(line), flush=True)


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


def small_runs(args, spw, CompiledSLAM, PinholeCamera, Config, ate_rmse, kw) -> int:
    """One JSON line per world seed and RANSAC seed: a small world tracked
    pair by pair, then ``shutdown()``; metric ATE, keyframes, landmarks,
    states and the probe's counts."""
    for world_seed in args.world_seeds:
        lefts, rights, K, Ts_gt = spw.small_frames(args.world, world_seed)
        for seed in args.seeds:
            cfg = spw.small_config(Config, args.world)
            cfg.tracking.chunk_size = args.chunk or cfg.tracking.chunk_size
            slam = CompiledSLAM(spw.camera(PinholeCamera, lefts, K, spw.SMALL_BASELINE), cfg, **kw)
            if seed is not None:
                reseed_step(slam, seed)
            probe = spw.Probe(slam)
            t0 = time.perf_counter()
            states = [slam.track([l, r], timestamp=i * spw.DT)["state"] for i, (l, r) in enumerate(zip(lefts, rights))]
            slam.shutdown()
            ts, Ts = slam.trajectory()
            rmse, pct, _ = spw.metric_ate(ate_rmse, ts, Ts, Ts_gt)
            print(json.dumps({"impl": args.impl, "world": args.world, "chunk": cfg.tracking.chunk_size,
                              "world_seed": world_seed, "seed": seed,
                              "ate_rmse_m": rmse, "ate_pct_of_path_metric": pct, "poses": len(ts),
                              "keyframes": slam.map.num_keyframes(), "landmarks": slam.map.num_map_points(),
                              "states": states, "final_state": slam.state.name, "cpu_s": time.perf_counter() - t0,
                              **probe.summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
