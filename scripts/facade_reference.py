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
    python scripts/facade_reference.py --impl torch --device cuda --world deploy --frames 32 --solver adam
    python scripts/facade_reference.py --impl jax --world dataset --seeds 13 0 1 --perturb 0 0.000001
    python scripts/facade_reference.py --impl torch --world dataset --accel-route pnp epipolar triangulation pose

The JAX package's figures are the reference that ``chip_smoke.py``'s facade
gates are set from; the port's CPU run is a rehearsal of the same phase
(the kernels' plain versions run in place of the kernels). ``--device
cuda`` runs the port on the card.
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


def refined_null(AtA, iters: int = 8, shifts=(1e-7, 1e-5)):
    """A candidate repair of the card's null vector (ROADMAP Q21.1):
    ``smallest_eigvec_psd``'s vector refined by ``iters`` steps of inverse
    iteration on ``AtA`` itself in float64, shifted by the smallest of
    ``shifts`` (times the mean diagonal) whose Cholesky factor exists; the
    unrefined vector where none does. ``smallest_eigvec_psd`` iterates on
    the Jacobi-equilibrated Gram, which on a noisy refit minimises under
    another norm than ``eigh``'s, and its 2e-5 shift leaves it unconverged
    where the two smallest eigenvalues lie below it."""
    import math

    import torch

    from visual_slam_tpu_torch.ops import linalg

    v0 = linalg.smallest_eigvec_psd(AtA)
    n = AtA.shape[-1]
    A = AtA.to(torch.float64)
    m = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).mean(-1), min=1e-30)[..., None, None]
    eye = torch.eye(n, dtype=torch.float64, device=AtA.device)
    L = None
    for shift in sorted(shifts, reverse=True):  # the largest first; a smaller one wherever it factors
        Lk, info = torch.linalg.cholesky_ex(A + shift * m * eye)
        ok = (info == 0)[..., None, None]
        L = torch.where(ok, Lk, math.nan) if L is None else torch.where(ok, Lk, L)
    x = v0.to(torch.float64)[..., None]
    for _ in range(iters):
        y = torch.linalg.solve_triangular(L, x, upper=False)
        y = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-2, keepdim=True), min=1e-20)
    x = x[..., 0].to(AtA.dtype)
    return torch.where(torch.isfinite(x).all(-1, keepdim=True), x, v0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--world", choices=("deploy", "dataset", "small", "endurance", "e2e"), required=True)
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
    ap.add_argument("--device", default="cpu", help="the port's device: cpu, or cuda on a card (the port only)")
    ap.add_argument("--accel-route", nargs="*", default=[], choices=("pnp", "epipolar", "triangulation", "pose"),
                    help="sites where the CPU takes the accelerator route (the port's on the card, JAX's on the "
                         "TPU): smallest_eigvec_psd for the null vectors of the DLT pose, the essential matrix "
                         "and triangulation, and the port's closed-form DLT pose")
    ap.add_argument("--accel-null", choices=("jax", "refined"), default="jax",
                    help="the null vector at the --accel-route sites: JAX's TPU route (smallest_eigvec_psd, the "
                         "card's), or that vector refined on the Gram itself in float64 (refined_null, Q21.1's "
                         "candidate repair; the port only, on any device)")
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
        if args.accel_route:  # the null vectors of the TPU route; JAX keeps its SVD pose on every backend
            from visual_slam_tpu.ops import epipolar, linalg, pnp, triangulation

            sites = {"pnp": pnp, "epipolar": epipolar, "triangulation": triangulation}
            for site in args.accel_route:
                if site != "pose":
                    sites[site].nullspace_vector = linalg.smallest_eigvec_psd
    else:
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.slam import SLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        kw = {"device": args.device}
        if args.threads:
            import torch

            torch.set_num_threads(args.threads)
        if args.accel_route:
            from visual_slam_tpu_torch.ops import epipolar, linalg, pnp, triangulation

            sites = {"pnp": pnp, "epipolar": epipolar, "triangulation": triangulation}
            null = linalg.smallest_eigvec_psd if args.accel_null == "jax" else refined_null
            for site in args.accel_route:
                if site == "pose":
                    pnp._dlt_pose = pnp._dlt_pose_closed
                else:
                    sites[site].nullspace_vector = null

    if args.world == "deploy":
        frames, K, Ts = fw.deploy_frames(args.frames or 64)
        cfg = fw.deploy_config(Config)
    elif args.world == "dataset":
        frames, K, Ts = fw.dataset_frames(args.frames or 32)
        cfg = fw.dataset_config(Config)
    elif args.world == "small":
        import dataset_world as dsw

        frames, K, Ts = dsw.small_frames(args.frames or dsw.SMALL_FRAMES)
        cfg = fw.dataset_config(Config, *dsw.SMALL_FEATURES_LEVELS)
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
        out["accel_route"] = args.accel_route
        if args.accel_route and args.impl == "torch":
            out["accel_null"] = args.accel_null
        if args.impl == "torch":
            out["device"] = args.device
        if slam.loop_closing is not None:
            out["closed_loops"] = [list(p) for p in slam.loop_closing.closed_loops]
            out["funnel"] = slam.loop_closing.funnel
        if args.trace:
            out["trace"] = " ".join(trace)
        print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
