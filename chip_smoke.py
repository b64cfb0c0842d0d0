#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card (nvidia-smi name and power limit) and refuses to run
   without CUDA: there is no CPU path.
2. Builds the CUDA kernels from ``visual_slam_tpu_torch/csrc``.
3. Holds each kernel (K1 patches+moments over all levels of a frame, K2
   Hamming top-2, K3 guided top-2, K4 Hamming top-2 against 64 candidate
   blocks, K5 32x32 window gather) against its plain PyTorch version on the
   card, at the shapes its path gives it, and times both: device time by
   CUDA events over back-to-back calls, host+device wall per synchronised
   call, and the bound (bytes over the HBM rate or operations over the
   peak) with the share of it reached. The batched forms of K1, K2 and K3
   (the batched VO step's, B = 4 at the same shapes) likewise, each also
   held at B = 1 to its one-sequence kernel, and the batched K1 at the
   stereo facade's B = 2 (its world's first pair). K1, K2 and K3 again at
   the RGB-D facade's shapes: K1 on its world's first frame (640x480) at
   1000 features, K2 at 1000 x 1000, K3 on its 2048-slot landmark block.
4. Tracking path: the fused mono tracking step with a 4096-slot local-map
   arena, 2000 features, 4 levels, 128 RANSAC hypotheses, over a rendered
   376x1240 sprite world (f = 718.856) in two chunks of 8 frames. Checks
   poses against ground truth and the kernels' launch counts, lists the host
   syncs inside one step, times single steps and chunks, and holds one frame
   against the same step run on the CPU through the plain versions.
   Then batched VO (``parallel.make_batched_vo``, BASELINE config 5), one
   JSON line per sub-phase: 4 sprite worlds like this one (seeds 0-3)
   tracked 16 frames at once with the local map and without; gates: every
   sequence as above and within R_ATOL / T_ATOL of the single step on it
   over the first chunk, the batched K1/K2/K3 launched (1, 1, 1) / (1, 1,
   0) times a step, at most 1.25x the single step's CUDA kernels
   (torch.profiler) and no more host syncs. Then bench_multiseq's setup at
   2000 and 4000 features: aggregate and single-step FPS, efficiency,
   syncs, peak memory, busy share (recorded, no gate).
5. Pose graphs at 256 nodes: bench_pose_graph's SE(3)
   problem and a drifted 256-node Sim(3) loop, cost checked to fall, timed
   per solve (the first solve pays torch.func's and the solver's set-up).
6. Loop path: the keyframes (every 4th frame) of a 200-frame ring sequence
   at 376x1240 around 2400 sprites, detected on the card, given drifted
   poses (scale 1 -> 1.3 and a slow yaw drift) and landmarks linked between
   consecutive keyframes by the tracking matcher (K2). Every keyframe goes
   through ``LoopClosing.process_keyframe`` (signature shortlist, K4, PnP,
   Sim(3) pose graph) as it is added. Checks that the revisit closes the
   loop onto one of the first keyframes with a lower keyframe ATE, K4's
   launch count, and one detect against the same detect on the CPU through
   the plain versions; prints the detection funnel and times detect/close.
7. Full pipeline: ``bench.bench_full_pipeline``'s deployment through the
   port's entry points, ``CompiledSLAM(camera, config).track()``, ``flush()``
   and ``trajectory()``: 64 frames of ``bench.synth_kitti_frames`` (seed 3,
   1500 sprites, 0.6 m steps) at 376x1240, 2000 features, self-promoting
   chunks of 8, a heavy (BA) boundary every second promotion, f16 upload,
   one BA bucket. Bootstrap within 16 frames, warm-up through two heavy
   cycles (host syncs per chunk counted there), a timed window aligned to
   the chunk with flush() inside it. Prints FPS, scale-aligned ATE and its
   share of the path, keyframes, landmarks, BA shapes and costs, the longest
   call, LOST and brute-recovery counts, K1-K3 launches and peak memory.
   Fails on a failed bootstrap, a LOST frame, a frame without a pose, a BA
   cost not finite or above its cost0, no heavy boundary in the timed
   window, launch counts that disagree with the detects and matches the run
   made, ATE above FP_ATE_PCT_MAX % of the path, or the first heavy BA
   solved again on the CPU disagreeing with the card's. Then the same
   deployment twice with async heavy boundaries (``tracking.async_boundary``
   at its default gates: 12 keyframes, cooloff 2), gated as above with
   FP_ASYNC_ATE_PCT_MAX: it prints the async and sync boundaries, cooloffs,
   landed corrections, the host ms of an async solve's start and landing
   and one solve's device ms (side stream), or that no async boundary ran;
   the second run counts the host syncs over the whole run and fails on a
   sync of the solve's or the boundary's code between an async solve's
   start and the next chunk's fetch, or a solve off the side stream.
   Then dense against sparse landmark-major BA at scripts/bench_ba_sparse.py's
   shapes (BA_SHAPES; its problem from tests/ba_world.py): median wall of
   BA_REPS synchronised solves, device ms, host syncs a solve (must be 0),
   both costs (within BA_COST_RTOL).
8. Host SLAM facade (``SLAM``, tests/facade_world.py's worlds), one JSON
   line per phase:
   a. deployment: ``bench.synth_kitti_frames(64, seed=3, step=0.6,
      n_sprites=1500)`` at 376x1240 through synchronous ``SLAM`` with
      bench_full_pipeline's settings that the facade reads (2000 features,
      4 levels, keyframe interval 4, BA window 16), loop closing off, with
      the tracker's default RANSAC seed and with FACADE_SEEDS: FPS after
      the bootstrap, keyframe and per-frame ATE, keyframes, landmarks, LOST
      and relocalization counts, host ms per frame by stage, host syncs per
      frame (the 8 frames after the bootstrap, by source line, default
      seed), K1-K4 launches, peak memory; then each seed's outcome. A run
      fails if it has a LOST frame or jumps scale (keyframe ATE above
      FACADE_JUMP_PCT). Fails on more failed runs than the JAX package has
      at the same seeds, a median ATE above FACADE_*_ATE_PCT_MAX, a median
      keyframe count outside FACADE_KF_RANGE, or launches that disagree
      with the detects, matches and guided matches the run made;
   b. endurance: bench_loop_endurance_device's world (320x240 ring, 200
      frames, a blackout at frames 60-62) with loop closing on and off:
      ATE, closures, relocalizations, LOST frames, the final state, the
      loop detection funnel, K4 launches; fails unless both end OK after at
      least one relocalization and closures reach the JAX package's;
   c. threaded: the deployment world through ``SLAM(threaded=True)``,
      THREADED_RUNS times (each thread interleaving is a new draw); every
      run must have no failed thread step and a ``shutdown()`` within 30
      s; a run fails with a LOST frame, a final state other than OK or a
      keyframe ATE above twice a's gate, and the phase fails when more runs
      fail than the JAX package's share of failed threaded runs allows;
   d. ``Processing``: an in-memory source of the deployment world's first
      16 frames with the KITTI P0 calibration; fails unless it ends OK with
      a pose for every frame after the bootstrap.
9. Stereo and RGB-D host facade (tests/depth_world.py), one JSON line per
   run: a stereo pair at the stereo world's width through the detector as
   one B = 2 batch against two single detects (keypoints exact, at least
   PAIR_BIT_SHARE_MIN of the descriptor bits); then
   a. stereo: bench_stereo_pipeline's world (48 pairs at 376x1240, the
      KITTI rig's 0.54 m baseline) through ``SLAM`` with the deployment
      settings, at the tracker's default RANSAC seed and DEPTH_SEEDS with
      ``MonoTracking``, then once with the fused step;
   b. RGB-D: TUM fr1's geometry (640x480, 1000 features), the JAX RGB-D
      test's sprite world over 32 frames with metric depth maps, the same
      runs;
   each run classed (clean, LOST, scale jump on the metric keyframe ATE)
   and printed with FPS after the bootstrap, host ms a frame by stage,
   syncs a frame (default seed), the share of keypoint slots with a valid
   depth, peak memory and K1-K4 launches. Per sensor it fails on more
   failed runs than the fewer of the JAX package's and the port's CPU
   count at these seeds (DEPTH_PORT_CPU_FAILED), a median metric ATE above
   max(2 x JAX's median, 2.0 %), a clean run's fitted scale outside
   DEPTH_SCALE_RANGE, a bootstrap after frame 0, a fused run that is not
   clean, or launches that disagree with the run's
   detects, matches and guided matches (K1 once a frame: for a stereo
   pair, the batched K1);
   c. ``Processing``: in-memory sources of each world's first 16 frames
      (the stereo pairs with a KITTI P0/P1 calibration, the RGB-D frames
      with their depth maps through ``get_depth``); fails unless each ends
      OK, bootstraps on frame 0 and poses every frame.
10. Loop pipeline (tests/loop_pipeline_world.py): bench_loop_pipeline's
   deployment through ``CompiledSLAM`` on the card, one JSON line per run:
   the 200-frame ring at 376x1240 around 2400 sprites with noise and
   brightness drift, 2000 features, self-promoting chunks of 8, a heavy
   boundary every second promotion; the frames rendered once and shared.
   a. on: loop closing on, bootstrap then two heavy cycles before the
      clock (host syncs per chunk counted there), a checkpoint after frame
      LP_CHECKPOINT (``flush()``, ``save``; off the clock);
   b. off: loop closing off, the same policy;
   c. resume: the id counters reset to 0 as in a new process,
      ``CompiledSLAM.resume(..., device="cuda")`` of the checkpoint, the
      frames after it tracked;
   d. small ring, where the JAX package's on pass closes no loop:
      test_compiled_slam_devpromo_loop_closing's 100-frame 320x240 world;
   e. async: loop closing on, async heavy boundaries at their default
      gates; gates: no LOST frame, OK, ATE <= max(2 x JAX's CPU figure,
      LP_ATE_PCT_FLOOR), K4 launched, an async boundary ran, every async
      solve on the side stream;
   f. sparse: loop closing on, ``sparse_obs="auto"``, then one more global
      BA over the final map, timed; gates as e., and every solve from the
      ``sparse_auto_min_window`` bucket on (closures' global BA and the
      final one included) in the sparse layout, read from the optimizer.
   Each prints FPS, the whole-trajectory ATE (% of path), keyframes,
   landmarks, LOST frames, each detect (ms, shortlist, top-2 matches, PnP
   inliers, candidate), each closure (keyframes, frame, inliers, ms of
   close, of its pose-graph solve and of its global BA), K1-K5 launches and
   peak memory; the checkpoint's bytes, save and resume ms. The gates are
   LP_JAX's comment's. K4 is then held exactly against its plain version on
   the arguments of the on pass's detect with the most real candidate
   blocks (its shortlist) and timed.
11. Prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``
   as the last line. Any failure raises and exits nonzero.

K5 has no caller in either package: only phase 3 launches it. The
kernels' launch counts add up the tracking, loop, full-pipeline, facade,
stereo facade and loop pipeline phases; the batched rows' count the batched
VO phase's batched steps, the B = 2 row's the stereo phases' pairs, the
RGB-D rows' the RGB-D phases' launches (each at least one), and the loop
pipeline's K4 row the K4 launches of its runs.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_FEATURES = 2000
N_LEVELS = 4
GRID = 8
N_HYP = 128
ARENA = 4096
H, W, FOCAL = 376, 1240, 718.856
CHUNK, N_CHUNKS = 8, 2
R_ATOL, T_ATOL = 0.01, 0.1  # first chunk against ground truth
MIN_INLIERS = 20
MOMENT_RTOL = 1e-5  # of sum |w * p|: the moments' f32 summation order differs
REPS = 20  # host+device wall: synchronised reps
DEVICE_REPS = 200  # device time: back-to-back calls between two CUDA events
SLEEP_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep's cycles per second, at or above the SM clock
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8_tc": 1979e12, "fp32": 67e12}
# Loop path: bench.bench_loop_pipeline's deployment, keyframes only.
LOOP_FRAMES, KF_EVERY, LOOP_SPRITES = 200, 4, 2400
C_REAL, C_PAD = 8, 64  # shortlist and candidate bucket of LoopClosing.detect
PG_NODES, PG_LOOPS, PG_ITERS = 256, 8, 10
# Full pipeline: bench.bench_full_pipeline's world and deployment.
FP_FRAMES, FP_SPRITES, FP_STEP, FP_SEED, FP_CHUNK, FP_HEAVY = 64, 1500, 0.6, 3, 8, 2
# ATE gate, % of path: max(2 x 0.279 %, the JAX package's own CPU run of
# bench_full_pipeline, and 2.0 %).
FP_ATE_PCT_MAX = 2.0
BA_COST_RTOL, BA_POSE_ATOL = 1e-3, 1e-3  # the heavy BA on the card against the CPU
# The same with tracking.async_boundary on at its default gates: max(2 x the
# JAX package's CPU run of it, 2.0 %); scripts/heavy_modes_reference.py
# --impl jax: 0.306 % of the path, 3 async and 5 sync boundaries, 2 landed
# corrections (largest |s - 1| 0.0032), 17 keyframes, no LOST frame.
FP_ASYNC_ATE_PCT_MAX = max(2 * 0.3058, 2.0)
# Dense against sparse BA: scripts/bench_ba_sparse.py's shapes (W, M, K).
BA_SHAPES, BA_REPS = ((16, 1024, 16), (32, 4096, 16), (64, 4096, 16)), 5
# Host facade (SLAM), tests/facade_world.py's worlds. The JAX package's CPU
# runs of them (scripts/facade_reference.py --seeds): deploy, over its
# tracker's default RANSAC key 13 and seeds 0-7, 21-37 keyframes (median
# 23), keyframe ATE 0.470-18.342 % of the path (median 0.610 %), per-frame
# ATE 0.524-18.738 % (median 1.571 %); two of these nine runs (seeds 2 and
# 4) jump scale on a keyframe posed from 12-15 inliers. Over seeds 0-23 it
# fails 3 of 24 runs: seeds 2 and 4 jump (14.9-18.3 %), seed 18 goes LOST
# at frame 62; the clean runs stay under 2.1 %. So one run is a draw, a
# LOST one included: from the port's state after frame 14 of a run that
# went LOST (scripts/facade_state_probe.py), 16 reseeded continuations go
# LOST in neither package, and from its state after frame 20 neither
# package relocalizes. Each of the nine seeded runs here is classed and
# printed; the gates read the count of failed runs and the medians of the
# ATEs and keyframe counts. Endurance, loop closing on and off alike:
# final state OK, 3 LOST frames (the blackout), 1 relocalization, 0
# closures, 96 keyframes, keyframe ATE 5.198 %. Gates: failed runs at most
# JAX's at these seeds, median ATE at most max(2 x JAX's median, 2.0 %),
# median keyframes within 30 % of 23, closures at least JAX's, ATE on
# below off only where JAX's was.
FACADE_FRAMES, FACADE_SYNC, PROCESSING_FRAMES = 64, 8, 16
FACADE_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)
FACADE_KF_ATE_PCT_MAX, FACADE_FRAME_ATE_PCT_MAX = 2.0, 3.142
FACADE_KF_RANGE = (17, 29)
FACADE_JUMP_PCT, FACADE_JAX_FAILED_RUNS = 5.0, 2
ENDURANCE_JAX_CLOSURES, ENDURANCE_JAX_ON_BELOW_OFF = 0, False
# Threaded facade (the deployment world, SLAM(threaded=True)): the JAX
# package's 8 CPU runs (scripts/depth_facade_reference.py --world
# deploy-threaded --reps 8) failed 3: two ended LOST (29 and 12 LOST frames,
# keyframe ATE 5.746 and 0.786 %), one relocalized after 2 LOST frames
# (0.241 %); the five clean runs ended at 0.152-0.897 %. A run here fails
# as those did, or above twice FACADE_KF_ATE_PCT_MAX; of THREADED_RUNS runs
# at most ceil(3 x 3/8) = 2 may.
THREADED_RUNS, THREADED_JAX_FAILED, THREADED_JAX_RUNS = 3, 3, 8
THREADED_FAILED_MAX = -(-THREADED_RUNS * THREADED_JAX_FAILED // THREADED_JAX_RUNS)
# Stereo and RGB-D facade (tests/depth_world.py), at the tracker's default
# RANSAC seed (13) and seeds 0-3, then the fused step at the default seed.
# The JAX package's CPU runs of the same worlds and seeds
# (scripts/depth_facade_reference.py): stereo, 5 clean runs, metric keyframe
# ATE (no scale alignment) 0.765-0.923 % of the path (median 0.788 %),
# fitted scale 0.987-0.992, 13 keyframes, depth on 0.306 of the keypoint
# slots; fused clean at 0.775 %. RGB-D: all 5 runs LOST in the world's last
# 1-6 frames (guided inliers fall to 47-57 of ~222, under the 0.25 ratio),
# metric ATE 1.202-1.297 % (median 1.236 %), fitted scale 1.036-1.039,
# depth on 0.926 of the slots; fused LOST the same way (1.233 %). The port's
# CPU runs of the same worlds and seeds (the same script, --impl torch; the
# kernels' plain versions) fail none, fused or not. Gates per sensor: failed
# runs (LOST, or a scale jump: metric keyframe ATE above FACADE_JUMP_PCT) at
# most the fewer of JAX's and the port's CPU count at these seeds (0 for
# both sensors: JAX's 5 of 5 on the RGB-D world would let every run fail);
# median metric ATE at most max(2 x JAX's median, 2.0 %); every clean run's
# fitted scale in DEPTH_SCALE_RANGE; the bootstrap on frame 0; the fused run
# clean.
DEPTH_SEEDS = (0, 1, 2, 3)
STEREO_FRAMES, RGBD_FRAMES, DEPTH_PROCESSING_FRAMES = 48, 32, 16
DEPTH_JAX = {"stereo": {"failed": 0, "median_pct": 0.788, "fused_clean": True, "kp_z_valid_frac": 0.3058},
             "rgbd": {"failed": 5, "median_pct": 1.236, "fused_clean": False, "kp_z_valid_frac": 0.9264}}
DEPTH_PORT_CPU_FAILED = {"stereo": 0, "rgbd": 0}
# Host ms a frame in detect of the mono facade's deploy run at seed 13 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 5), printed beside the
# stereo and RGB-D runs' own.
MONO_FACADE_DETECT_MS = 41.51
DEPTH_SCALE_RANGE = (0.8, 1.25)
PAIR_BIT_SHARE_MIN = 0.999  # a stereo pair's batched descriptors against two single detects
# Batched VO (parallel.make_batched_vo, BASELINE config 5): bench_multiseq's
# 4 sequences, its 30 timed steps after one warm-up over 4 distinct batches,
# at bench.py's 2000 features and config 5's 4000.
MS_B, MS_STEPS, MS_BATCHES, MS_REPS = 4, 30, 4, 3
MS_FEATURES = (2000, 4000)
MS_PROFILE_STEPS = 4
MS_KERNEL_RATIO_MAX = 1.25  # CUDA kernels of a batched step over a single step's
STEP_SPANS = ("detect", "match", "guided_match", "ransac_pnp", "fallback_gn")
# Loop pipeline: bench_loop_pipeline's world and deployment
# (tests/loop_pipeline_world.py), loop closing on and off, and a system
# resumed from the on pass's checkpoint after LP_CHECKPOINT. The JAX
# package's CPU run of it (scripts/loop_pipeline_reference.py): on, no
# closure, scale-aligned ATE 0.283 % of the path, 40 keyframes, 3181
# landmarks, no LOST frame, bootstrap on frame 6; off 0.332 %, 40
# keyframes; the checkpoint after frame 103 (a chunk end) holds 21
# keyframes and 1596 landmarks in 1637061 bytes, and JAX's own system
# resumed from it goes LOST for 89 of the 96 frames after it (whole
# trajectory 0.991 %). As the on pass closes nothing there, the small ring
# (test_compiled_slam_devpromo_loop_closing's world, where the JAX test
# asserts a closure; the JAX package closes kf 31 -> kf 2 at frame 92 on the
# CPU) runs too. Gates, fixed before the first run on the card: on, no LOST
# frame, OK at the end, ATE <= max(2 x JAX's, LP_ATE_PCT_FLOOR), K4
# launched; closures >= max(1, JAX's) where JAX's on pass closes, else at
# least one on the small ring (which ends OK); off, no LOST frame, ATE <=
# max(2 x JAX's, LP_ATE_PCT_FLOOR), K4 never launched; resumed, no LOST
# frame, OK at the end, the saved keyframe and landmark counts restored,
# every feature block on the card, a closure after resuming where the
# uninterrupted on pass closed after the checkpoint, whole-trajectory ATE
# <= max(2 x the on pass's, LP_ATE_PCT_FLOOR).
LP_JAX = {"on_closures": 0, "on_ate_pct": 0.2828, "off_ate_pct": 0.3323, "async_ate_pct": 0.1946,
          "sparse_ate_pct": 0.3264}
LP_CHECKPOINT, LP_DT, LP_ATE_PCT_FLOOR = 103, 0.1, 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = REPS, warmup: int = 3) -> tuple[float, float]:
    """(median, min) host+device wall milliseconds per call of fn(): a host
    clock around each call and a synchronise, so the wrapper's checks, its
    allocations and the launch-and-sync floor are inside the figure."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts)


def device_ms(fn, n: int = DEVICE_REPS, warmup: int = 5) -> tuple[float, bool]:
    """Device milliseconds per call of fn(): CUDA events around n calls made
    back to back, with no synchronise between them, over the count.

    A sleep kernel queued first holds the card while the host enqueues the
    n calls, so the host's cost per call (checks, ctypes, Python) opens no
    gap between them and the events time the device alone. Returns (ms,
    gapless): gapless is False when the card had already started the calls
    before the host finished enqueuing them (a sleep too short, or more
    launches than the launch queue holds, as the plain versions make); the
    figure then includes host gaps and is an upper bound."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = min(1.0, 1.5 * n * (time.perf_counter() - t0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        gapless = not start.query()
        end.synchronize()
        if gapless:
            break
        sleep_s = min(1.0, 4 * sleep_s)
    return start.elapsed_time(end) / n, gapless


def bound(n_bytes: float, ops: dict[str, float]) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over their unit's peak rate. ``ops`` maps a unit
    of ``PEAK_OPS_PER_S`` to the operations this call's data needs there;
    the units run side by side, so the slowest of them bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = {unit: n / PEAK_OPS_PER_S[unit] * 1e3 for unit, n in ops.items()}
    unit = max(t_ops, key=t_ops.get)
    by_bytes = t_bytes >= t_ops[unit]
    return dict(bound_ms=max(t_bytes, t_ops[unit]), bound_by="bytes" if by_bytes else "operations",
                bound_unit="hbm" if by_bytes else unit, bound_bytes=int(n_bytes),
                bound_ops={u: int(n) for u, n in ops.items()})


def kernel_row(name, source, replaces, fn, plain, err, work, library=None, library_note=None) -> dict:
    """One row of the kernels JSON: device time (``device_ms``, events) and
    host+device wall (``ms``, as in the rows of earlier versions) of the
    kernel, of its plain version and, where one PyTorch call computes the
    same function, the device time of that call; the bound and the share of
    it reached. ``work`` is ``bound()``'s dict for this call's inputs."""
    dev, gapless = device_ms(fn)
    plain_dev, plain_gapless = device_ms(plain)
    host, plain_host = timed(fn), timed(plain)
    lib = device_ms(library)[0] if library is not None else None
    row = dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err, ms=host[0],
               plain_ms=plain_host[0], device_ms=dev, device_gapless=gapless, plain_device_ms=plain_dev,
               plain_device_gapless=plain_gapless, **work, share_of_bound=work["bound_ms"] / dev, library_ms=lib,
               library_note=library_note)
    log(f"{name}: device {dev:.4f} ms{'' if gapless else ' (host gaps)'}, plain {plain_dev:.4f} ms"
        f"{'' if plain_gapless else ' (host gaps)'}; host+device wall {host[0]:.4f} (min {host[1]:.4f}), plain "
        f"{plain_host[0]:.4f} (min {plain_host[1]:.4f}); bound {work['bound_ms']:.5f} ms by {work['bound_unit']} "
        f"({work['bound_bytes']} B, {work['bound_ops']} ops), share {row['share_of_bound']:.3f}; library "
        f"{'none: ' + library_note if lib is None else f'{lib:.4f} ms'}")
    return row


@contextlib.contextmanager
def count_syncs(torch, tag=None):
    """Count the host synchronisations inside the block by the port's
    source line that caused them (``torch.cuda.set_sync_debug_mode``);
    with ``tag``, each key is prefixed by ``tag(stack)``, the port's frames
    of the sync's call stack."""
    sync_at = collections.Counter()

    def note_sync(message, *args, **kwargs):
        frames_ = [f for f in traceback.extract_stack() if "visual_slam_tpu_torch" in f.filename]
        if frames_ and "synchroniz" in str(message).lower():
            where = f"{frames_[-1].filename.split('visual_slam_tpu_torch/')[-1]}:{frames_[-1].lineno}"
            sync_at[where if tag is None else f"{tag(frames_)} {where}"] += 1

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sync_at
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown


def make_world_frames(render_mod, np, seed: int = 0, depths: bool = False):
    """Sprite world sized like bench.synth_kitti_frames (900 sprites,
    x -30..40 m, y -8..8 m, z 8..50 m) drawn from ``seed``, seen along
    tests/render.py's forward-lateral path with slow yaw. Returns (K, Ts,
    frames, z-buffer of frame 0), or every frame's z-buffer with ``depths``."""
    rng = np.random.default_rng(seed)
    world = render_mod.make_world(rng, n_sprites=900, x_range=(-30, 40), y_range=(-8, 8), z_range=(8, 50))
    Ts = render_mod.camera_path(1 + CHUNK * N_CHUNKS, step=0.25)
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]], np.float32)
    frames = np.stack([render_mod.render(world, T, K, W, H) for T in Ts]).astype(np.float32)
    zbufs = [render_mod.render_with_depth(world, T, K, W, H)[1] for T in (Ts if depths else Ts[:1])]
    return K, Ts, frames, np.stack(zbufs) if depths else zbufs[0]


def touched(torch, shape, yx, size=31, lo=-15):
    """Pixels of an (H, W) image that the clamped size x size windows at
    ``yx`` read: the union of the windows, each pixel counted once."""
    H_, W_ = shape
    off = torch.arange(lo, lo + size, device=yx.device)
    rows = (yx[:, 0].long().clamp(-1, H_)[:, None] + off).clamp(0, H_ - 1)
    cols = (yx[:, 1].long().clamp(-1, W_)[:, None] + off).clamp(0, W_ - 1)
    mask = torch.zeros(shape, dtype=torch.bool, device=yx.device)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def hamming_fixture(np, rng, n):
    """K2's inputs at n x n: random 256-bit descriptors, 2n/5 near matches,
    blocks of n/20 query ties (column argmin) and train ties (argbest,
    second == best), ~10 % invalid queries and ~5 % invalid trains:
    (d1, d2) uint32 words and (v1, v2) bool."""
    d2 = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    near, ties = 2 * n // 5, n // 20  # 800 near matches and blocks of 100 ties at n = 2000
    d1[:near] = d2[:near] ^ (rng.random((near, 8)) < 0.05).astype(np.uint32)
    d1[near:near + ties] = d1[:ties]  # query ties (column argmin)
    d2[n // 2:n // 2 + ties] = d2[:ties]  # train ties (argbest and second == best)
    return d1, d2, rng.random(n) > 0.1, rng.random(n) > 0.05


def guided_fixture(np, rng, M, n, radius, width=W, height=H):
    """K3's inputs: an arena of M landmarks over a ``width`` x ``height``
    image with landmark ties, n keypoints, each planted within 20 px of a landmark with a near
    descriptor, ~20 % landmarks and ~5 % keypoints invalid: (lm_desc
    int32, lm_ok, lm_uv, kp_desc int32, kp_valid, kp_xy), and the valid
    pairs inside ``radius``."""
    lm_uv = np.stack([rng.uniform(0, width, M), rng.uniform(0, height, M)], 1).astype(np.float32)
    lm_desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    lm_desc[1:M // 10:2] = lm_desc[0:M // 10 - 1:2]  # landmark ties
    kp_xy = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1).astype(np.float32)
    kp_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    for j in range(0, 2 * n, 2):
        kp_desc[j // 2] = lm_desc[j] ^ (rng.random(8) < 0.04).astype(np.uint32)
        kp_xy[j // 2] = lm_uv[j] + rng.uniform(-20, 20, 2)
    lm_ok = rng.random(M) > 0.2
    kp_valid = rng.random(n) > 0.05
    d2g = ((lm_uv[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
    in_radius = int(((d2g <= radius * radius) & lm_ok[:, None] & kp_valid[None, :]).sum())
    return (lm_desc.view(np.int32), lm_ok, lm_uv, kp_desc.view(np.int32), kp_valid, kp_xy), in_radius


def k1_levels_row(torch, np, frame, n_features, name="patches_and_moments_levels"):
    """K1 on the N_LEVELS levels of ``frame`` with ``n_features``' level
    quotas, in one launch as detect_and_describe makes it, against its plain
    version (patches exact, moments within MOMENT_RTOL), then timed: its row
    of the kernels JSON."""
    from visual_slam_tpu_torch.ops import orb, pyramid
    from visual_slam_tpu_torch.ops.detector import detect_level, level_quotas
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_levels, patches_and_moments_levels_ref

    dev = torch.device("cuda")
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).to(dev)
    w = torch.from_numpy(orb.MOMENT_W_NP).to(dev)
    levels = [lvl.contiguous() for lvl in pyramid.build_pyramid(img, N_LEVELS, 1.2)]
    yxs = [detect_level(lvl, k, 20.0, GRID, 16)[0] for lvl, k in zip(levels, level_quotas(n_features, N_LEVELS, 1.2))]
    k1_args = (levels, [pyramid.gaussian_blur(lvl) for lvl in levels], yxs, w)
    mom, pat = patches_and_moments_levels(*k1_args)
    mom_r, pat_r = patches_and_moments_levels_ref(*k1_args)
    torch.cuda.synchronize()
    if not torch.equal(pat, pat_r):
        raise AssertionError(f"{name}: patches differ from the plain version")
    raw = torch.cat([orb.extract_patches(lvl, yx) for lvl, yx in zip(levels, yxs)])
    scale = raw.reshape(raw.shape[0], -1).abs().double() @ w.abs().double()
    diff = (mom - mom_r).abs().double()
    if not bool((diff <= MOMENT_RTOL * scale).all()):
        raise AssertionError(f"{name}: moments off by {float(diff.max())} (tolerance {MOMENT_RTOL} of sum |w*p|)")
    err = float(diff.max())
    log(f"{name}: levels {[tuple(lvl.shape) for lvl in levels]} keypoints {[int(yx.shape[0]) for yx in yxs]}, one "
        f"launch: patches exact, moments max abs err {err}")
    n_kp = sum(int(yx.shape[0]) for yx in yxs)
    # Bytes: the raw and blurred pixels the windows touch, yx in, 961 floats
    # of patch and 2 of moments out per keypoint; operations: a multiply-add
    # for each nonzero moment weight (the disk's pixels off its axes).
    k1_bytes = (sum(2 * 4 * touched(torch, tuple(lvl.shape), yx) for lvl, yx in zip(levels, yxs))
                + n_kp * (8 + 961 * 4 + 8))
    return kernel_row(
        name, "visual_slam_tpu_torch/csrc/patches_moments.cu", "visual_slam_tpu/ops/pallas_patches.py:144",
        lambda: patches_and_moments_levels(*k1_args), lambda: patches_and_moments_levels_ref(*k1_args),
        err, bound(k1_bytes, {"fp32": n_kp * 2 * int(np.count_nonzero(orb.MOMENT_W_NP))}),
        library_note="no single PyTorch call gives the disk-masked moments and the windows together")


def k2_row(torch, np, rng, n, name="hamming_top2"):
    """K2 at ``n`` x ``n`` with planted ties and 10% invalid rows against its
    plain version (exact), then timed: its row of the kernels JSON."""
    from visual_slam_tpu_torch.ops import match_kernels as mk

    dev = torch.device("cuda")
    d1, d2, v1, v2 = hamming_fixture(np, rng, n)
    args = [torch.from_numpy(d1.view(np.int32)).to(dev), torch.from_numpy(d2.view(np.int32)).to(dev),
            torch.from_numpy(v1).to(dev), torch.from_numpy(v2).to(dev)]
    out = mk.hamming_top2(*args)
    ref = mk.hamming_top2_ref(*args)
    torch.cuda.synchronize()
    for field, a, b in zip(("best", "second", "argbest", "col_argmin"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {field} differs from the plain version")
    log(f"{name} at {n}x{n}: exact ({int(v1.sum())} valid queries)")
    # Operations: 2*256 int8 multiply-adds of the bit product for each pair
    # of a valid row and a valid column (an invalid pair needs no distance);
    # bytes: the packed descriptors and masks in, best/second/argbest and
    # the column argmin out.
    return kernel_row(
        name, "visual_slam_tpu_torch/csrc/hamming_top2.cu", "visual_slam_tpu/ops/pallas_kernels.py:99",
        lambda: mk.hamming_top2(*args), lambda: mk.hamming_top2_ref(*args), 0.0,
        bound(2 * n * 33 + n * 12 + n * 4, {"int8_tc": 2 * 256 * int(v1.sum()) * int(v2.sum())}),
        library_note="no single PyTorch call gives the top-2, the argbest and the column argmin")


def k3_row(torch, np, rng, M, n, name="guided_top2", size=(W, H)):
    """K3 at ``M`` landmarks x ``n`` keypoints over an image of ``size``,
    matches planted inside a 25 px radius, against its plain version
    (exact), then timed: its row of the kernels JSON."""
    from visual_slam_tpu_torch.ops import match_kernels as mk

    dev = torch.device("cuda")
    fixture, in_radius = guided_fixture(np, rng, M, n, 25.0, *size)
    args = [torch.from_numpy(a).to(dev) for a in fixture] + [torch.tensor(25.0 * 25.0, device=dev)]
    lm_idx, valid = mk.guided_top2(*args)
    r_idx, r_valid = mk.guided_top2_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(valid, r_valid) and torch.equal(lm_idx, r_idx)):
        raise AssertionError(f"{name}: lm_idx/valid differ from the plain version")
    if int(r_valid.sum()) < n // 10:
        raise AssertionError(f"{name}: the fixture matched only {int(r_valid.sum())} keypoints")
    # Operations: M*K gate tests at 5 fp32 operations, and the Hamming
    # distance of each valid pair inside the radius as a bit product, 2*256
    # int8 multiply-adds on the tensor cores.
    log(f"{name} at {M}x{n}: exact ({int(r_valid.sum())} keypoints matched, {in_radius} valid pairs inside the radius)")
    return kernel_row(
        name, "visual_slam_tpu_torch/csrc/guided_top2.cu", "visual_slam_tpu/ops/pallas_kernels.py:250",
        lambda: mk.guided_top2(*args), lambda: mk.guided_top2_ref(*args), 0.0,
        bound((M + n) * (32 + 1 + 8) + 4 + n * 5, {"fp32": M * n * 5, "int8_tc": in_radius * 2 * 256}),
        library_note="no single PyTorch call gives the gated top-2 and the per-keypoint landmark argmin")


def k4_row(torch, args, name="hamming_top2_batched"):
    """K4 on ``args`` (query descriptors (n, 8), candidate blocks (C, m, 8),
    their masks) against its plain version, exactly, padding blocks (no
    valid column) giving best = BIG; then timed: its row of the kernels
    JSON. The work counts the real blocks only: a padding block needs its
    masks read and its outputs written, not its descriptors; in a real block
    2 x 256 int8 multiply-adds for each valid pair."""
    from visual_slam_tpu_torch.ops import match_kernels as mk

    q, blocks, vq, vb = args
    n, (C, m) = q.shape[0], blocks.shape[:2]
    out, ref = mk.hamming_top2_batched(*args), mk.hamming_top2_batched_ref(*args)
    torch.cuda.synchronize()
    for field, a, b in zip(("best", "second", "argbest", "col_argmin"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {field} differs from the plain version")
    pad = ~vb.any(1)
    if not (bool((out[0][pad] == mk.BIG).all()) and int(out[3][pad].abs().sum()) == 0):
        raise AssertionError(f"{name}: padding blocks must give best = BIG and col_argmin 0")
    real = int((~pad).sum())
    log(f"{name}: {n}x{C}x{m} ({real} real blocks): exact")
    valid_pairs = int(vq.sum()) * int(vb.sum())
    return kernel_row(
        name, "visual_slam_tpu_torch/csrc/hamming_top2.cu", "visual_slam_tpu/ops/pallas_kernels.py:99",
        lambda: mk.hamming_top2_batched(*args), lambda: mk.hamming_top2_batched_ref(*args), 0.0,
        bound(n * 33 + real * m * 32 + C * m + C * (n * 12 + m * 4), {"int8_tc": 2 * 256 * valid_pairs}),
        library_note="no single PyTorch call gives the top-2, the argbest and the column argmin")


def check_kernels(torch, np, frame, K):
    """Each kernel against its plain version on the card, at main-path
    shapes, then timed (``kernel_row``); returns the rows of the kernels
    JSON (launches filled later)."""
    from visual_slam_tpu_torch.ops.patch_kernels import extract_patches32, extract_patches32_ref

    dev = torch.device("cuda")
    img = torch.from_numpy(frame).to(dev)
    # K1 on the four levels of a rendered frame (K_l = 643/537/447/373 at
    # 2000 features), K2 at 2000 x 2000, K3 at 4096 landmarks x 2000.
    rng = np.random.default_rng(1)
    n = N_FEATURES
    near, ties = 2 * n // 5, n // 20  # as many as hamming_fixture plants
    rows = [k1_levels_row(torch, np, frame, n), k2_row(torch, np, rng, n), k3_row(torch, np, rng, ARENA, n)]

    # K4 at query 2000 x 64 candidate blocks of 2000: 8 real blocks with
    # planted near-duplicates, row and column ties and ~10% invalid rows,
    # 56 padding blocks (copies of block 0, all invalid), as detect builds.
    q = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    q[n - ties:] = q[:ties]  # query ties (column argmin)
    vq = rng.random(n) > 0.1
    blocks = rng.integers(0, 2**32, (C_PAD, n, 8), dtype=np.uint64).astype(np.uint32)
    vb = np.zeros((C_PAD, n), bool)
    for c in range(C_REAL):
        picked = rng.choice(n, near, replace=False)
        blocks[c, :near] = q[picked] ^ (rng.random((near, 8)) < 0.05).astype(np.uint32)
        blocks[c, n // 2:n // 2 + ties] = blocks[c, :ties]  # train ties
        vb[c] = rng.random(n) > 0.1
    blocks[C_REAL:] = blocks[0]
    args = [torch.from_numpy(q.view(np.int32)).to(dev), torch.from_numpy(blocks.view(np.int32)).to(dev),
            torch.from_numpy(vq).to(dev), torch.from_numpy(vb).to(dev)]
    rows.append(k4_row(torch, args))

    # K5 at 2000 keypoints of the frame, borders and corners included.
    Hf, Wf = frame.shape
    yx = np.stack([rng.integers(0, Hf, n), rng.integers(0, Wf, n)], 1).astype(np.int32)
    yx[:8] = [[0, 0], [0, Wf - 1], [Hf - 1, 0], [Hf - 1, Wf - 1], [0, Wf // 2], [Hf - 1, 7], [Hf // 2, 0], [9, Wf - 1]]
    args = [img.contiguous(), torch.from_numpy(yx).to(dev)]
    out = extract_patches32(*args)
    ref = extract_patches32_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K5: windows differ from the plain version")
    log(f"K5 {n} keypoints of {Hf}x{Wf}: exact")
    # The library call: one advanced-index gather, with the clamped index
    # tensors built outside the timed region (the port never calls it).
    off = torch.arange(-15, 17, device=dev)
    g_rows = (args[1][:, 0].long()[:, None] + off).clamp(0, Hf - 1)[:, :, None]
    g_cols = (args[1][:, 1].long()[:, None] + off).clamp(0, Wf - 1)[:, None, :]
    if not torch.equal(args[0][g_rows, g_cols], ref):
        raise AssertionError("K5: the library gather differs from the plain version")
    rows.append(kernel_row(
        "extract_patches32", "visual_slam_tpu_torch/csrc/extract_patches32.cu",
        "visual_slam_tpu/ops/pallas_patches.py:68",
        lambda: extract_patches32(*args), lambda: extract_patches32_ref(*args), 0.0,
        bound(4 * touched(torch, (Hf, Wf), args[1], 32) + n * 8 + n * 1024 * 4, {"fp32": 0}),
        library=lambda: args[0][g_rows, g_cols]))
    return rows


def batched_k1_row(torch, np, frames, name="patches_and_moments_batched"):
    """The batched K1 on the four levels of ``frames`` (B frames, stacked as
    the batched detect stacks them: one launch for all frames and levels)
    against its plain version, at B = 1 against the one-frame kernel, then
    timed: its row of the kernels JSON."""
    from visual_slam_tpu_torch.ops import orb, pyramid
    from visual_slam_tpu_torch.ops.detector import detect_level, level_quotas
    from visual_slam_tpu_torch.ops.patch_kernels import (
        patches_and_moments_batched,
        patches_and_moments_batched_ref,
        patches_and_moments_levels,
    )

    dev = torch.device("cuda")
    Bn = len(frames)
    imgs = torch.from_numpy(np.stack(frames)).to(dev)
    w = torch.from_numpy(orb.MOMENT_W_NP).to(dev)
    levels = [lvl.contiguous() for lvl in pyramid.build_pyramid(imgs, N_LEVELS, 1.2)]
    yxs = [detect_level(lvl, k, 20.0, GRID, 16)[0] for lvl, k in zip(levels, level_quotas(N_FEATURES, N_LEVELS, 1.2))]
    args = (levels, [pyramid.gaussian_blur(lvl) for lvl in levels], yxs, w)
    mom, pat = patches_and_moments_batched(*args)
    mom_r, pat_r = patches_and_moments_batched_ref(*args)
    one = patches_and_moments_levels(*[[x[0] for x in a] for a in args[:3]], w)
    b1 = patches_and_moments_batched(*[[x[:1] for x in a] for a in args[:3]], w)
    torch.cuda.synchronize()
    if not torch.equal(pat, pat_r):
        raise AssertionError("batched K1: patches differ from the plain version")
    raw = torch.stack([torch.cat([orb.extract_patches(lvl[b], yx[b]) for lvl, yx in zip(levels, yxs)])
                       for b in range(Bn)])
    scale = raw.reshape(*raw.shape[:2], -1).abs().double() @ w.abs().double()
    diff = (mom - mom_r).abs().double()
    if not bool((diff <= MOMENT_RTOL * scale).all()):
        raise AssertionError(f"batched K1: moments off by {float(diff.max())} (tolerance {MOMENT_RTOL} of sum |w*p|)")
    if not (torch.equal(b1[0][0], one[0]) and torch.equal(b1[1][0], one[1])):
        raise AssertionError("batched K1 at B = 1 differs from the one-frame kernel")
    err = float(diff.max())
    n_kp = Bn * sum(int(yx.shape[1]) for yx in yxs)
    log(f"batched K1 B={Bn} levels {[tuple(lvl.shape) for lvl in levels]}, one launch: patches exact, moments max abs "
        f"err {err}; B = 1 equals the one-frame kernel bit for bit")
    k1_bytes = (sum(2 * 4 * touched(torch, tuple(lvl.shape[1:]), yx[b]) for lvl, yx in zip(levels, yxs)
                    for b in range(Bn)) + n_kp * (8 + 961 * 4 + 8))
    return kernel_row(
        name, "visual_slam_tpu_torch/csrc/patches_moments.cu",
        "visual_slam_tpu/ops/pallas_patches.py:144",
        lambda: patches_and_moments_batched(*args), lambda: patches_and_moments_batched_ref(*args), err,
        bound(k1_bytes, {"fp32": n_kp * 2 * int(np.count_nonzero(orb.MOMENT_W_NP))}),
        library_note="no single PyTorch call gives the disk-masked moments and the windows together")


def check_rgbd_kernels(torch, np, frame, n_features):
    """K1, K2 and K3 at the RGB-D facade's shapes, each against its plain
    version, then timed: K1 on the levels of ``frame`` (the RGB-D world's
    first frame) at the ``n_features`` budget, K2 at that budget squared
    (the tracker's match), K3 on the landmark block that budget gives
    (``Tracking._local_landmark_block``: max(2048, 2 x the budget) slots).
    Returns their rows of the kernels JSON."""
    h, w = frame.shape
    n, arena = n_features, max(2048, 2 * n_features)
    rng = np.random.default_rng(2)
    return [k1_levels_row(torch, np, frame, n, f"patches_and_moments_levels, RGB-D {w}x{h}"),
            k2_row(torch, np, rng, n, f"hamming_top2, RGB-D {n} x {n}"),
            k3_row(torch, np, rng, arena, n, f"guided_top2, RGB-D {arena} x {n}", size=(w, h))]


def check_batched_kernels(torch, np, frames):
    """The batched forms of K1, K2 and K3 (the batched VO step's) against
    their plain versions on the card at B = MS_B and the main path's shapes,
    each also at B = 1 against its one-sequence kernel, then timed
    (``kernel_row``); returns their rows of the kernels JSON."""
    from visual_slam_tpu_torch.ops import match_kernels as mk

    dev = torch.device("cuda")
    rows = []
    Bn = len(frames)

    rows.append(batched_k1_row(torch, np, frames))

    # K2 paired: MS_B pairs at 2000 x 2000, each with planted near matches,
    # row and column ties and ~10% invalid rows, as check_kernels' K2.
    rng = np.random.default_rng(21)
    n = N_FEATURES
    d1, d2, v1, v2 = (np.stack(a) for a in zip(*[hamming_fixture(np, rng, n) for _ in range(Bn)]))
    args = [torch.from_numpy(a).to(dev) for a in (d1.view(np.int32), d2.view(np.int32), v1, v2)]
    out = mk.hamming_top2_paired(*args)
    ref = mk.hamming_top2_paired_ref(*args)
    one = mk.hamming_top2(*[a[0] for a in args])
    b1 = mk.hamming_top2_paired(*[a[:1] for a in args])
    torch.cuda.synchronize()
    for name, a, b in zip(("best", "second", "argbest", "col_argmin"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"paired K2: {name} differs from the plain version")
    if not all(torch.equal(a[0], b) for a, b in zip(b1, one)):
        raise AssertionError("paired K2 at B = 1 differs from the one-pair kernel")
    log(f"paired K2 B={Bn} x {n}x{n}: exact; B = 1 equals the one-pair kernel")
    pairs = int((v1.sum(1) * v2.sum(1)).sum())
    rows.append(kernel_row(
        "hamming_top2_paired", "visual_slam_tpu_torch/csrc/hamming_top2.cu", "visual_slam_tpu/ops/pallas_kernels.py:99",
        lambda: mk.hamming_top2_paired(*args), lambda: mk.hamming_top2_paired_ref(*args), 0.0,
        bound(Bn * (2 * n * 33 + n * 12 + n * 4), {"int8_tc": 2 * 256 * pairs}),
        library_note="no single PyTorch call gives the top-2, the argbest and the column argmin"))

    # K3 batched: MS_B arenas of 4096 against 2000 keypoints each, matches
    # planted inside the radius, a radius per sequence (the step widens it
    # with each sequence's own rotation, 25 to 100 px).
    M = ARENA
    radii = np.array([25.0, 25.0, 40.0, 60.0][:Bn] + [25.0] * max(0, Bn - 4), np.float32)
    fixtures, pairs = zip(*[guided_fixture(np, rng, M, n, r) for r in radii])
    in_radius = sum(pairs)
    args = [torch.from_numpy(np.stack(a)).to(dev) for a in zip(*fixtures)] + [torch.from_numpy(radii ** 2).to(dev)]
    lm_idx, valid = mk.guided_top2_batched(*args)
    r_idx, r_valid = mk.guided_top2_batched_ref(*args)
    one = mk.guided_top2(*[a[0] for a in args])
    b1 = mk.guided_top2_batched(*[a[:1] for a in args])
    torch.cuda.synchronize()
    if not (torch.equal(valid, r_valid) and torch.equal(lm_idx, r_idx)):
        raise AssertionError("batched K3: lm_idx/valid differ from the plain version")
    if not (torch.equal(b1[0][0], one[0]) and torch.equal(b1[1][0], one[1])):
        raise AssertionError("batched K3 at B = 1 differs from the one-arena kernel")
    if int(r_valid.sum()) < Bn * n // 10:
        raise AssertionError(f"batched K3 fixture matched only {int(r_valid.sum())} keypoints")
    log(f"batched K3 B={Bn} x {M}x{n}, radii {radii.tolist()} px: exact ({int(r_valid.sum())} keypoints matched, "
        f"{in_radius} valid pairs inside the radii); B = 1 equals the one-arena kernel")
    rows.append(kernel_row(
        "guided_top2_batched", "visual_slam_tpu_torch/csrc/guided_top2.cu", "visual_slam_tpu/ops/pallas_kernels.py:250",
        lambda: mk.guided_top2_batched(*args), lambda: mk.guided_top2_batched_ref(*args), 0.0,
        bound(Bn * ((M + n) * (32 + 1 + 8) + 4 + n * 5), {"fp32": Bn * M * n * 5, "int8_tc": in_radius * 2 * 256}),
        library_note="no single PyTorch call gives the gated top-2 and the per-keypoint landmark argmin"))
    return rows


def zbuf_landmarks(np, xy, valid, zbuf, K, T_w2c=None):
    """Landmarks of the valid keypoints ``xy`` (N, 2) that the z-buffer
    sees, in the world frame of the camera pose ``T_w2c`` (frame 0's
    camera frame when None): (N, 3) f32 and (N,) bool."""
    Kinv = np.linalg.inv(K)
    lm = np.zeros((len(xy), 3), np.float32)
    has = np.zeros(len(xy), bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and zbuf[v, u] > 0.5:
            X = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * zbuf[v, u]
            lm[i] = X if T_w2c is None else T_w2c[:3, :3].T @ (X - T_w2c[:3, 3])
            has[i] = True
    return lm, has


def initial_state(torch, np, step, frame0, zbuf, K, device):
    """Frame-0 keypoints get landmarks from the z-buffer; the same
    landmarks fill the first slots of the 4096-slot arena."""
    from visual_slam_tpu_torch import pipeline

    feats = step.detect(torch.from_numpy(frame0).to(device))
    lm, has = zbuf_landmarks(np, feats.xy.cpu().numpy(), feats.valid.cpu().numpy(), zbuf, K)
    lm_pos = np.zeros((ARENA, 3), np.float32)
    lm_desc = np.zeros((ARENA, 8), np.int32)
    lm_valid = np.zeros(ARENA, bool)
    lm_pos[:N_FEATURES], lm_desc[:N_FEATURES], lm_valid[:N_FEATURES] = lm, feats.desc.cpu().numpy(), has

    def make(seed: int = 0, on=device):
        s = pipeline.init_track_state(feats, lm, has, np.eye(4), seed=seed, local_map_size=ARENA, device=on)
        return pipeline.set_local_map(s, lm_pos, lm_desc, lm_valid)

    return make, int(has.sum())


def profile_calls(torch, fn, n: int) -> dict:
    """fn() n times under torch.profiler, after one call outside it: CUDA
    kernels per call (memory copies and sets apart), the device busy share
    (the union of the device events' intervals, leaving out the
    ``record_function`` ranges, which also appear on the device and cover
    its idle gaps, over the span of all events), busy ms per call, and the
    host ms per call inside each span of ``STEP_SPANS``. The profiler
    slows the host (about 3x on the full pipeline), so the share under it
    is lower than without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in on_dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in on_dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    host = collections.Counter()
    for e in events:
        if e.name in STEP_SPANS and e.device_type == DeviceType.CPU:
            host[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / n
    return dict(kernels_per_call=len(kernels) / n, busy_share=busy / span, busy_ms_per_call=busy / 1e3 / n,
                window_ms_per_call=span / 1e3 / n, host_span_ms_per_call={k: round(v, 3) for k, v in host.items()})


def cycling(step, state, frames):
    """A call that advances ``state`` by one step over the next of
    ``frames``, round and round."""
    hold = {"state": state, "i": 0}

    def call():
        hold["state"], _ = step(hold["state"], frames[hold["i"] % len(frames)])
        hold["i"] += 1

    return call


def step_costs(torch, calls: dict, n: int) -> dict:
    """For each named call: ``profile_calls``' figures over n calls and the
    host syncs of one more call by source line."""
    res = {}
    for name, call in calls.items():
        res[name] = profile_calls(torch, call, n)
        torch.cuda.synchronize()
        with count_syncs(torch) as syncs:
            call()
        torch.cuda.synchronize()
        res[name]["syncs"] = dict(syncs.most_common())
    return res


def timed_fps(step, state, frames, n_seq: int) -> float:
    """bench_multiseq's timing: one warm-up step on frames[0], then
    MS_STEPS steps cycling through ``frames`` with a value fetch from the
    last inside the window; frames per second over ``n_seq`` sequences."""
    state, out = step(state, frames[0])
    float(out.T_w2c.flatten()[0])
    t0 = time.perf_counter()
    for i in range(MS_STEPS):
        state, out = step(state, frames[i % len(frames)])
    float(out.T_w2c.flatten()[0])
    return n_seq * MS_STEPS / (time.perf_counter() - t0)


def run_multiseq(torch, np, dev, render_mod) -> list[int]:
    """The batched VO step (``parallel.make_batched_vo``), B = MS_B:
    1. tracking: MS_B sprite worlds (``make_world_frames`` at seeds 0 to
       MS_B - 1, each with its own z-buffer start state and RANSAC seed b)
       tracked for 16 frames with the local map and without. Without it
       the step holds only a fixed reference block and, like the JAX
       step, loses frame 0's after about 5 frames of this path (world 0:
       534, 55, 2 inliers on frames 1, 5, 6); so there each frame's
       features become the next reference, with landmarks from its
       z-buffer at the ground-truth pose, as frame 0's. Every sequence
       keeps the tracking phase's gates (MIN_INLIERS; R_ATOL / T_ATOL on the
       first chunk) and stays within R_ATOL / T_ATOL of the single step on
       the same sequence with the same seed over the same first chunk
       (after it, each trajectory drifts from ground truth on its own, and
       both drifts are printed); each batched step launches the
       batched K1, K2 and K3 (1, 1, 1) times with the local map and (1, 1,
       0) without, and the one-sequence wrappers never; under
       torch.profiler a batched step runs at most MS_KERNEL_RATIO_MAX times
       a single step's CUDA kernels, and it has no more host syncs.
    2. throughput, no gate: bench_multiseq's setup (``synth_kitti_frames()``,
       depths drawn in 8-40 m, generator seed s for sequence s, MS_BATCHES
       distinct batches cycled, one warm-up, MS_STEPS timed steps ending in
       a value fetch from the last) at each of MS_FEATURES: aggregate FPS
       and the single step's on the same frames (MS_REPS reps, in turns),
       the efficiency, host syncs per step by source line, peak memory, the
       device busy share and the host time by stage under the profiler.
    Prints one JSON line per sub-phase; returns the batched K1, K2 and K3
    launches over the phase's batched steps."""
    import bench

    from visual_slam_tpu_torch import pipeline
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels
    from visual_slam_tpu_torch.parallel import make_batched_vo

    batched = (patches_and_moments_batched, mk.hamming_top2_paired, mk.guided_top2_batched)
    single = (patches_and_moments_levels, mk.hamming_top2, mk.guided_top2)
    total = [0, 0, 0]
    t0 = time.perf_counter()
    worlds = [make_world_frames(render_mod, np, seed=s, depths=True) for s in range(MS_B)]
    K = worlds[0][0]
    n_frames = CHUNK * N_CHUNKS
    imgs = torch.from_numpy(np.stack([w[2][1:] for w in worlds], axis=1)).to(dev)  # (frames, B, H, W)
    log(f"multiseq worlds: {MS_B} x {n_frames + 1} frames {imgs.shape[2:]} in {time.perf_counter() - t0:.2f} s")
    for local_map in (True, False):
        kw = dict(num_features=N_FEATURES, n_levels=N_LEVELS, grid=GRID, pnp_hypotheses=N_HYP, local_map=local_map,
                  width=W, height=H)
        bstep = make_batched_vo(K, device=dev, **kw)
        step = pipeline.make_track_step(K, device=dev, **kw)
        makers = [initial_state(torch, np, step, w[2][0], w[3][0], K, dev)[0] for w in worlds]

        def refresh(state, feats, i, b=None):
            """Without the local map the step tracks against its reference
            alone and never promotes: the reference becomes frame i + 1
            (this step's), its landmarks from that frame's z-buffer at the
            ground-truth pose, for one sequence b or for all."""
            if local_map:
                return state
            seqs = range(MS_B) if b is None else [b]
            xy = feats.xy.cpu().numpy().reshape(len(seqs), -1, 2)
            valid = feats.valid.cpu().numpy().reshape(len(seqs), -1)
            lms = [zbuf_landmarks(np, xy[j], valid[j], worlds[s][3][i + 1], K, worlds[s][1][i + 1])
                   for j, s in enumerate(seqs)]
            lm, has = (np.stack(x) for x in zip(*lms))
            return pipeline.swap_reference(state, feats, lm if b is None else lm[0], has if b is None else has[0])

        def stacked():
            return pipeline.stack_track_states([make(seed=b) for b, make in enumerate(makers)])

        torch.cuda.synchronize()
        for fn in batched + single:
            fn.launches = 0
        st, outs = stacked(), []
        for i in range(n_frames):
            st, o = bstep(st, imgs[i])
            st = refresh(st, o.features, i)
            outs.append(o)
        torch.cuda.synchronize()
        launches = [fn.launches for fn in batched]
        single_launches = [fn.launches for fn in single]
        total = [a + b for a, b in zip(total, launches)]
        T_b = torch.stack([o.T_w2c for o in outs], 1).cpu().numpy()  # (B, frames, 4, 4)
        n_inl = torch.stack([o.n_inliers for o in outs], 1).cpu().numpy()
        n_guided = torch.stack([o.guided_valid.sum(-1) for o in outs], 1).cpu().numpy()
        T_s = []
        for b, make in enumerate(makers):
            ss, Ts_b = make(seed=b), []
            for i in range(n_frames):
                ss, o = step(ss, imgs[i, b])
                ss = refresh(ss, o.features, i, b)
                Ts_b.append(o.T_w2c)
            T_s.append(torch.stack(Ts_b).cpu().numpy())
        T_s = np.stack(T_s)
        gt = np.stack([w[1][1:] for w in worlds])
        err_R = np.abs(T_b[:, :CHUNK, :3, :3] - gt[:, :CHUNK, :3, :3]).max(axis=(1, 2, 3))
        err_t = np.abs(T_b[:, :CHUNK, :3, 3] - gt[:, :CHUNK, :3, 3]).max(axis=(1, 2))
        # Against the single step on the first chunk, the tracking gates'
        # window; over all 16 frames both trajectories drift apart from
        # ground truth on their own (recorded).
        d_R = np.abs(T_b[:, :CHUNK, :3, :3] - T_s[:, :CHUNK, :3, :3]).max(axis=(1, 2, 3))
        d_t = np.abs(T_b[:, :CHUNK, :3, 3] - T_s[:, :CHUNK, :3, 3]).max(axis=(1, 2))
        d_t_all = np.abs(T_b[..., :3, 3] - T_s[..., :3, 3]).max(axis=(1, 2))
        gt_t_all = {name: np.abs(T[..., :3, 3] - gt[..., :3, 3]).max(axis=(1, 2)).tolist()
                    for name, T in (("batched", T_b), ("single", T_s))}

        # Kernels per step and host syncs, batched against single (sequence 0).
        costs = step_costs(torch, {"batched": cycling(bstep, stacked(), imgs),
                                   "single": cycling(step, makers[0](seed=0), imgs[:, 0])}, MS_PROFILE_STEPS)
        prof_b, prof_s = costs["batched"], costs["single"]
        n_sync_b, n_sync_s = sum(prof_b["syncs"].values()), sum(prof_s["syncs"].values())
        ratio = prof_b["kernels_per_call"] / prof_s["kernels_per_call"]
        rep = dict(phase="multiseq_track", local_map=local_map, B=MS_B, frames=n_frames,
                   min_inliers=n_inl.min(axis=1).tolist(), min_guided=n_guided.min(axis=1).tolist(),
                   first_chunk_err_R=err_R.tolist(), first_chunk_err_t=err_t.tolist(),
                   vs_single_dR=d_R.tolist(), vs_single_dt=d_t.tolist(), vs_single_dt_all_frames=d_t_all.tolist(),
                   err_t_all_frames=gt_t_all,
                   launches_K1_K2_K3=launches, launches_one_sequence_wrappers=single_launches,
                   kernels_per_step={"batched": prof_b["kernels_per_call"], "single": prof_s["kernels_per_call"],
                                     "ratio": ratio},
                   busy_share_profiled={"batched": prof_b["busy_share"], "single": prof_s["busy_share"]},
                   syncs_per_step={"batched": n_sync_b, "single": n_sync_s}, syncs_by_line_batched=prof_b["syncs"])
        log(json.dumps(rep))
        expected = [n_frames, n_frames, n_frames if local_map else 0]
        if launches != expected or single_launches != [0, 0, 0]:
            raise AssertionError(f"multiseq (local_map={local_map}): batched launches {launches} != {expected} or "
                                 f"one-sequence launches {single_launches} != 0")
        if not np.isfinite(T_b).all() or (n_inl < MIN_INLIERS).any():
            raise AssertionError(f"multiseq (local_map={local_map}): non-finite poses or frames below {MIN_INLIERS} "
                                 f"inliers: {n_inl.min(axis=1).tolist()}")
        if (err_R > R_ATOL).any() or (err_t > T_ATOL).any():
            raise AssertionError(f"multiseq (local_map={local_map}): first chunk off ground truth: R {err_R} t {err_t}")
        if (d_R > R_ATOL).any() or (d_t > T_ATOL).any():
            raise AssertionError(f"multiseq (local_map={local_map}): first chunk's batched poses off the single "
                                 f"steps: R {d_R} t {d_t}")
        if ratio > MS_KERNEL_RATIO_MAX:
            raise AssertionError(f"multiseq (local_map={local_map}): {prof_b['kernels_per_call']} CUDA kernels a "
                                 f"batched step, {ratio:.3f} x the single step's {prof_s['kernels_per_call']}")
        if n_sync_b > n_sync_s:
            raise AssertionError(f"multiseq (local_map={local_map}): {prof_b['syncs']} host syncs a batched step, "
                                 f"more than the single step's {prof_s['syncs']}")

    # Throughput: bench_multiseq's setup through the port.
    frames, K_np, _ = bench.synth_kitti_frames()
    Kinv = np.linalg.inv(K_np)
    batches = [torch.from_numpy(np.stack([frames[(s + i) % len(frames)] for s in range(MS_B)])).to(dev)
               for i in range(MS_BATCHES)]
    for nf in MS_FEATURES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bstep = make_batched_vo(K_np, device=dev, num_features=nf, n_levels=4)
        step = pipeline.make_track_step(K_np, device=dev, num_features=nf, n_levels=4)
        rng = np.random.default_rng(7)
        starts = []
        for s in range(MS_B):
            feats0 = step.detect(torch.from_numpy(frames[s % len(frames)]).to(dev))
            xy = feats0.xy.cpu().numpy()
            z = rng.uniform(8, 40, nf).astype(np.float32)
            rays = np.concatenate([xy, np.ones((nf, 1), np.float32)], 1) @ Kinv.T
            starts.append((feats0, (rays * z[:, None]).astype(np.float32)))

        def state(s):
            return pipeline.init_track_state(starts[s][0], starts[s][1], starts[s][0].valid, np.eye(4), seed=s,
                                             device=dev)

        def batched_state():
            return pipeline.stack_track_states([state(s) for s in range(MS_B)])

        singles = [b[0] for b in batches]  # sequence 0's frames
        fps = {"batched": [], "single": []}
        for _ in range(MS_REPS):
            fps["batched"].append(timed_fps(bstep, batched_state(), batches, MS_B))
            fps["single"].append(timed_fps(step, state(0), singles, 1))
        peak = torch.cuda.max_memory_allocated() / 2**20
        costs = step_costs(torch, {"batched": cycling(bstep, batched_state(), batches),
                                   "single": cycling(step, state(0), singles)}, 2 * MS_BATCHES)
        agg, one = statistics.median(fps["batched"]), statistics.median(fps["single"])
        rep = dict(phase="multiseq_throughput", features=nf, B=MS_B, steps=MS_STEPS,
                   agg_fps_median=agg, agg_fps_min=min(fps["batched"]), single_fps_median=one,
                   single_fps_min=min(fps["single"]), efficiency=agg / (MS_B * one),
                   agg_fps_reps=fps["batched"], single_fps_reps=fps["single"], peak_mib=peak, profiled=costs)
        log(json.dumps(rep))
    return total


def run_loop_path(torch, np, step, dev, counters):
    """The loop path: keyframes of the ring sequence added one at a time,
    each through LoopClosing.process_keyframe. Returns the launch counts of
    ``counters`` over the path; raises if a check fails."""
    import loop_world as lw

    from visual_slam_tpu_torch import interop
    from visual_slam_tpu_torch import map as tmap
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.loop_closing import LoopClosing
    from visual_slam_tpu_torch.ops.matching import match_descriptors

    t0 = time.perf_counter()
    K, T_gt, imgs, depths = lw.ring_keyframes(LOOP_FRAMES, KF_EVERY, W, H, FOCAL, LOOP_SPRITES)
    N = len(T_gt)
    log(f"loop world: {N} keyframes (every {KF_EVERY}th of {LOOP_FRAMES} frames) of {W}x{H}, {LOOP_SPRITES} sprites, "
        f"rendered in {time.perf_counter() - t0:.2f} s")
    T_d, s = lw.drift(T_gt)
    # Revisits, from ground truth: keyframes past the detection gap within
    # 1.5 m and 0.3 rad of one of the first three.
    C = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_gt])
    fwd = T_gt[:, 2, :3]
    cam = PinholeCamera(W, H, K)
    lc = LoopClosing(tmap.Map(), cam, Config())
    revisits = [k for k in range(lc.min_gap + 1, N)
                if any(np.linalg.norm(C[k] - C[j]) < 1.5 and fwd[k] @ fwd[j] > np.cos(0.3) for j in range(3))]
    if not revisits:
        raise AssertionError("the loop world has no revisit keyframe")

    # detect/close timed and their results recorded around the real calls.
    detect_ms, close_ms, funnels, closures = {}, [], {}, []
    detect, close = lc.detect, lc.close

    def timed_detect(kf):
        t = time.perf_counter()
        det = detect(kf)
        torch.cuda.synchronize()
        detect_ms[kf.keyframe_id] = (time.perf_counter() - t) * 1e3
        if lc.funnel:
            funnels[kf.keyframe_id] = dict(lc.funnel, candidate=None if det is None else det["candidate"].keyframe_id)
        return det

    def timed_close(kf, det, use_sim3=True):
        # The keyframe ATE over the map's keyframes just before and after:
        # keyframes added later carry the synthetic drift, not poses
        # tracked against the corrected map.
        n = lc.map.num_keyframes()
        ate_pre = lw.keyframe_ate(np.stack([k.T_w2c for k in lc.map.get_keyframes()]), T_gt[:n])
        t = time.perf_counter()
        res = close(kf, det, use_sim3)
        torch.cuda.synchronize()
        close_ms.append((time.perf_counter() - t) * 1e3)
        ate_post = lw.keyframe_ate(np.stack([k.T_w2c for k in lc.map.get_keyframes()]), T_gt[:n])
        closures.append(dict(res, kf=kf.keyframe_id, candidate=det["candidate"].keyframe_id, ate=(ate_pre, ate_post),
                             n_inliers=det["n_inliers"], n_matches=det["n_matches"], s_meas=det["s_meas"]))
        return res

    lc.detect, lc.close = timed_detect, timed_close
    for fn in counters:
        fn.launches = 0
    prev, mirror, kf_ids = None, None, []
    for k in range(N):
        feats = step.detect(torch.from_numpy(imgs[k]).to(dev))
        link = None
        if prev is not None:
            pf = prev.get_features(0)
            r = match_descriptors(feats.desc, pf.desc, feats.valid, pf.valid, feats.angle, pf.angle,
                                  use_orientation=True)
            link = (r["train_idx"].cpu().numpy(), r["valid"].cpu().numpy())
        kf = tmap.KeyFrame(features=[feats], timestamp=0.1 * KF_EVERY * k, pose=tmap.Pose(T_d[k]))
        X, has = lw.landmarks(feats.xy.cpu().numpy(), feats.valid.cpu().numpy(), depths[k], K, T_d[k], s[k])
        lw.add_keyframe(tmap, lc.map, kf, X, has, prev, link)
        kf_ids.append(kf.keyframe_id)
        if k == revisits[0]:  # the map as the revisit's detect sees it, for the CPU check
            mirror = interop.map_from_numpy(lc.map.get_keyframes(), lc.map.get_map_points(), device="cpu")
        lc.process_keyframe(kf)
        prev = kf
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]

    first3 = set(kf_ids[:3])
    for kid, f in funnels.items():
        row = kf_ids.index(kid)
        top = sorted(zip(f["n_matches"], f["shortlist"]), reverse=True)[:2]
        recall = f" recall {'yes' if first3 & set(f['shortlist']) else 'no'}" if row in revisits else ""
        log(f"kf {row:2d}: detect {detect_ms[kid]:.2f} ms, top-2 (matches, kf) "
            f"{[(n, kf_ids.index(c)) for n, c in top]}, PnP inliers {f['inliers']}, "
            f"candidate {None if f['candidate'] is None else kf_ids.index(f['candidate'])}{recall}")
    for c in closures:
        log(f"closed kf {kf_ids.index(c['kf'])} -> kf {kf_ids.index(c['candidate'])}: {c['n_matches']} matches, "
            f"{c['n_inliers']} inliers, s_meas {c['s_meas']}, {c['covis_edges']} covis edges, "
            f"pose-graph cost {c['pose_graph_cost']}, {c['landmarks_corrected']} landmarks corrected, "
            f"keyframe ATE (scale-aligned, keyframes 0-{kf_ids.index(c['kf'])}) {c['ate'][0]:.4f} -> {c['ate'][1]:.4f} m")
    # Recorded beside the gated ATE above: the end of the run over all
    # keyframes, the uncorrected ones added after the closure included.
    ate_end = lw.keyframe_ate(np.stack([k.T_w2c for k in lc.map.get_keyframes()]), T_gt)
    log(f"keyframe ATE (scale-aligned, all {N} keyframes): drifted input {lw.keyframe_ate(T_d, T_gt):.4f} m, "
        f"end of run {ate_end:.4f} m, {len(closures)} closure(s)")
    reached = len(funnels)
    log(f"loop path: {len(detect_ms)} detects ({reached} reached the matcher), median "
        f"{statistics.median([detect_ms[k] for k in funnels]):.2f} ms where they did; close {close_ms} ms; "
        f"{lc.map.num_map_points()} landmarks; launches K1/K2/K3/K4 {launches[:4]}")
    if not closures:
        raise AssertionError("no loop closed")
    c = closures[0]
    if c["candidate"] not in first3:
        raise AssertionError(f"loop closed onto kf {kf_ids.index(c['candidate'])}, not one of the first three")
    if c["n_inliers"] < 20 or not np.isfinite(c["pose_graph_cost"]):
        raise AssertionError(f"closure with {c['n_inliers']} inliers, cost {c['pose_graph_cost']}")
    if not c["ate"][1] < c["ate"][0]:
        raise AssertionError(f"keyframe ATE did not fall: {c['ate']}")
    expected = [N, N - 1, 0, reached]
    if launches[:4] != expected:
        raise AssertionError(f"loop path launches K1/K2/K3/K4 {launches[:4]} != {expected}")

    # The first revisit's detect on the CPU, through the plain versions.
    q_id = kf_ids[revisits[0]]
    if q_id not in funnels:
        raise AssertionError(f"the revisit kf {revisits[0]} never reached the matcher")
    lc_cpu = LoopClosing(mirror, cam, Config())
    t = time.perf_counter()
    det_cpu = lc_cpu.detect(mirror.get_keyframe_by_id(q_id))
    gpu = funnels[q_id]
    cand_cpu = None if det_cpu is None else det_cpu["candidate"].keyframe_id
    log(f"kf {revisits[0]} detect on the CPU ({time.perf_counter() - t:.2f} s): shortlist "
        f"{lc_cpu.funnel['shortlist'] == gpu['shortlist']}, n_matches {lc_cpu.funnel['n_matches'] == gpu['n_matches']}, "
        f"candidate {cand_cpu == gpu['candidate']}")
    if (lc_cpu.funnel["shortlist"], lc_cpu.funnel["n_matches"], cand_cpu) != (gpu["shortlist"], gpu["n_matches"],
                                                                             gpu["candidate"]):
        raise AssertionError(f"CPU detect {lc_cpu.funnel} / {cand_cpu} != CUDA detect {gpu}")
    return launches


def fp_config(Config):
    """bench.bench_full_pipeline's configuration (its defaults)."""
    cfg = Config()
    cfg.feature.num_features = N_FEATURES
    cfg.feature.num_pyramid_levels = N_LEVELS
    cfg.feature.grid_cells = GRID
    cfg.tracking.pnp_hypotheses = N_HYP
    cfg.tracking.local_map_size = ARENA
    cfg.tracking.keyframe_interval = 4
    cfg.tracking.chunk_size = FP_CHUNK
    cfg.tracking.device_promotion = True
    cfg.tracking.heavy_boundary_every = FP_HEAVY
    cfg.tracking.upload_f16 = True
    cfg.optimization.max_points = 4096
    cfg.optimization.window_size = 16
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = 2048
    cfg.initialization.min_inliers = min(100, max(30, N_FEATURES // 20))
    return cfg


def heavy_counters(slam) -> dict:
    """Count what ``slam``'s heavy boundaries do (either package's
    ``CompiledSLAM``; the port's own steps where it has them): async and
    sync self-promoting chunks, cooloffs started, landed solves with a
    device correction and the largest |s - 1|, solves by layout and the
    layouts of the solves inside loop closing's ``close`` (its global BA);
    on the port also the host ms of each async solve's start and landing,
    whether it ran on the side stream, and ``window``: True from an async
    solve's start to the next chunk's fetch. Returns the live dict."""
    c = dict(async_chunks=0, sync_chunks=0, cooloffs=0, corrections=0, max_scale_dev=0.0, solves_dense=0,
             solves_sparse=0, dense_buckets=set(), closing_ba_sparse=[], async_start_ms=[], async_finish_ms=[],
             side_stream=[], window=False, last_async=None)
    run_async0, run_sync0 = slam._run_chunk_devpromo_async, slam._run_chunk_devpromo
    finish0, start0 = slam._finish_async_solve, slam.optimizer.solve_start
    in_close = [False]

    def run_async(*a):
        c["async_chunks"] += 1
        before = slam._async_cooloff
        out = run_async0(*a)
        c["cooloffs"] += slam._async_cooloff > before
        return out

    def run_sync(*a):
        c["sync_chunks"] += 1
        return run_sync0(*a)

    def finish(correct_device):
        landing, t = slam._async_bnd is not None, time.perf_counter()
        U = finish0(correct_device)
        if landing:
            c["async_finish_ms"].append((time.perf_counter() - t) * 1e3)
        if U is not None:
            c["corrections"] += 1
            c["max_scale_dev"] = max(c["max_scale_dev"], abs(float(U[2]) - 1.0))
        return U

    def solve_start(*a, **k):
        pending = start0(*a, **k)
        sparse = pending.get("obs_pose") is not None
        c["solves_sparse" if sparse else "solves_dense"] += 1
        if not sparse:
            c["dense_buckets"].add(int(pending["T"].shape[0]))
        if in_close[0]:
            c["closing_ba_sparse"].append(sparse)
        return pending

    slam._run_chunk_devpromo_async, slam._run_chunk_devpromo = run_async, run_sync
    slam._finish_async_solve, slam.optimizer.solve_start = finish, solve_start
    if hasattr(slam, "_start_ba"):  # the port
        start_ba0, fetch0 = slam._start_ba, slam._fetch_chunk

        def start_ba(overlap=False):
            t = time.perf_counter()
            pending = start_ba0(overlap=overlap)
            if overlap and pending is not None:
                c["async_start_ms"].append((time.perf_counter() - t) * 1e3)
                c["side_stream"].append(pending.get("ready") is not None)
                c["window"], c["last_async"] = True, pending
            return pending

        def fetch(*a):
            c["window"] = False
            return fetch0(*a)

        slam._start_ba, slam._fetch_chunk = start_ba, fetch
    lc = slam.loop_closing
    if lc is not None:
        close0 = lc.close

        def close(*a, **k):
            in_close[0] = True
            try:
                return close0(*a, **k)
            finally:
                in_close[0] = False

        lc.close = close
    return c


def solve_device_ms(torch, pending, ocfg, dev, n: int = 3):
    """Device ms of one solve of ``pending``'s packed problem on the card
    (``device_ms``: CUDA events around ``n`` back-to-back solves), in its
    layout and with the configuration's iterations; None without one."""
    if pending is None:
        return None
    from visual_slam_tpu_torch.backend.ba import bundle_adjust_robust, bundle_adjust_robust_sparse
    from visual_slam_tpu_torch.utils.tree import to_device

    problem = to_device(pending["problem"], dev)
    solve = bundle_adjust_robust_sparse if pending["sparse"] else bundle_adjust_robust
    n1 = max(ocfg.n_iter // 2, 1)
    return device_ms(lambda: solve(problem, n_iter=n1, n_iter2=max(ocfg.n_iter - n1, 1), huber=ocfg.huber_delta / FOCAL,
                                   lam0=ocfg.lm_lambda0, trim_factor=3.0), n=n, warmup=1)[0]


def heavy_summary(c) -> dict:
    """``heavy_counters``' dict for a report: counts, and host ms medians."""
    med = lambda x: statistics.median(x) if x else None  # noqa: E731
    return dict(async_chunks=c["async_chunks"], sync_chunks=c["sync_chunks"], cooloffs=c["cooloffs"],
                corrections=c["corrections"], max_scale_dev=c["max_scale_dev"], solves_dense=c["solves_dense"],
                solves_sparse=c["solves_sparse"], dense_buckets=sorted(c["dense_buckets"]),
                closing_ba_sparse=c["closing_ba_sparse"],
                async_start_ms_median=med(c["async_start_ms"]), async_finish_ms_median=med(c["async_finish_ms"]),
                side_stream=all(c["side_stream"]) if c["side_stream"] else None)


def run_full_pipeline(torch, np, dev, counters, async_boundary=False, sync_check=False):
    """The deployment bench.bench_full_pipeline times, through the port's
    entry points: CompiledSLAM(camera, config).track() per frame, flush(),
    trajectory(). Bootstrap within 16 frames, warm through two heavy cycles
    (host syncs counted there), a timed window aligned to the chunk with
    flush() inside it. ``async_boundary``: the same with
    ``tracking.async_boundary`` on at its default gates, gated on
    FP_ASYNC_ATE_PCT_MAX; with ``sync_check`` the host syncs are counted
    over the whole run (FPS then includes the counting) and no host sync of
    the solve's code or the boundary's may lie between an async solve's
    start and the next chunk's fetch. Returns (launches of ``counters``
    over the run, report dict); raises if a gate fails."""
    import bench

    from visual_slam_tpu_torch.backend.ba import bundle_adjust_robust
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.models import CompiledSLAM
    from visual_slam_tpu_torch.models import compiled_slam as cs_mod
    from visual_slam_tpu_torch.utils.metrics import ate_rmse
    from visual_slam_tpu_torch.utils.tree import to_device

    t0 = time.perf_counter()
    frames, K_np, Ts_gt = bench.synth_kitti_frames(n_frames=FP_FRAMES, H=H, W=W, f=FOCAL, n_sprites=FP_SPRITES,
                                                   seed=FP_SEED, step=FP_STEP)
    log(f"full pipeline world: {FP_FRAMES} frames {frames[0].shape}, {FP_SPRITES} sprites, step {FP_STEP} m, "
        f"rendered in {time.perf_counter() - t0:.2f} s")
    cfg = fp_config(Config)
    cfg.tracking.async_boundary = async_boundary
    name = "full pipeline" + (", async" if async_boundary else "") + (" (syncs counted)" if sync_check else "")
    ate_max = FP_ASYNC_ATE_PCT_MAX if async_boundary else FP_ATE_PCT_MAX
    cam = PinholeCamera(width=W, height=H, K=np.asarray(K_np, np.float64))
    torch.cuda.reset_peak_memory_stats()
    slam = CompiledSLAM(cam, cfg, device=dev)

    # Instrumentation around the real calls: what the run detected and
    # matched (for the launch counts), boundaries, BA solves.
    seen = collections.Counter()
    heavy_ms, solves, first_heavy = [], [], {}
    tracker, step, opt = slam._feature_tracker, slam._step, slam.optimizer
    detect0, match0, forward0 = tracker.detectAndCompute, tracker.match, step.forward
    heavy0, brute0, run_chunk0 = slam._boundary_heavy, slam._brute_recover, slam._run_chunk
    start0, finish0 = opt.solve_start, opt.solve_finish

    def detect(img):
        seen["detect"] += 1
        return detect0(img)

    def match(f1, f2, **kw):
        seen["match"] += 1
        return match0(f1, f2, **kw)

    def forward(state, img):
        seen["step"] += 1
        return forward0(state, img)

    def brute(out, ts):
        seen["brute"] += 1
        seen["brute_match"] += min(3, slam.map.num_keyframes())
        return brute0(out, ts)

    def run_chunk():
        seen["chunk"] += 1
        return run_chunk0()

    def boundary_heavy(kf):
        seen["heavy"] += 1
        t = time.perf_counter()
        heavy0(kf)
        heavy_ms.append((time.perf_counter() - t) * 1e3)

    def solve_start(*a, **kw):
        pending = start0(*a, **kw)
        if seen["heavy"] and not first_heavy:
            first_heavy["pending"] = pending  # its device T and cost stay untouched by the writeback
        return pending

    def solve_finish(pending):
        res = finish0(pending)
        solves.append((res["cost0"], res["cost"], pending["problem"].T_w2c.shape[0], pending["problem"].points.shape[0]))
        return res

    tracker.detectAndCompute, tracker.match, step.forward = detect, match, forward
    slam._boundary_heavy, slam._brute_recover, slam._run_chunk = boundary_heavy, brute, run_chunk
    opt.solve_start, opt.solve_finish = solve_start, solve_finish

    # Host ms by boundary stage, over the timed window: launching the
    # chunk's steps, the compaction, the fetch (the wait for the device),
    # adoption, the landmark budget, the heavy BA, re-installing the state.
    stage_ms = collections.Counter()
    timing = {"on": False}

    def stage(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if timing["on"]:
                    stage_ms[name] += (time.perf_counter() - t) * 1e3
        return run

    slam._chunk = stage("dispatch", slam._chunk)
    slam._compact_fn = stage("compact", slam._compact_fn)
    slam._adopt_device_keyframe = stage("adopt", slam._adopt_device_keyframe)
    slam._enforce_budget = stage("budget", slam._enforce_budget)
    slam._boundary_heavy = stage("heavy BA", slam._boundary_heavy)
    slam._install_reference = stage("install", slam._install_reference)
    fetch0 = cs_mod.to_host
    cs_mod.to_host = stage("fetch", fetch0)
    hc = heavy_counters(slam)

    for fn in counters:
        fn.launches = 0
    states = []
    i = 0
    t0 = time.perf_counter()
    while slam.state.name != "OK" and i < 16:
        states.append(slam.track([frames[i]], timestamp=i * 0.1)["state"])
        i += 1
    if slam.state.name != "OK":
        raise AssertionError(f"bootstrap failed: state {slam.state.name} after {i} frames")
    boot = i - 1
    log(f"bootstrap on frame {boot} ({time.perf_counter() - t0:.2f} s): {slam.map.num_keyframes()} keyframes, "
        f"{slam.map.num_map_points()} landmarks")
    n_end = len(frames) - (len(frames) - i) % FP_CHUNK
    warm_end = min(i + 2 * max(FP_CHUNK, 4) * FP_HEAVY + 1, n_end - 2 * max(FP_CHUNK, 8))
    chunks0 = seen["chunk"]
    t0 = time.perf_counter()
    def tag(stack):
        """Where a sync lies: out of a solve's window, or in it: in the
        tracking step (main stream), the landing of the solve at the next
        boundary, the solve's code, or other boundary code."""
        if not hc["window"]:
            return "out"
        names = {f.name for f in stack}
        files = {f.filename.split("visual_slam_tpu_torch/")[-1] for f in stack}
        if "_finish_async_solve" in names:
            return "window/landing"
        if files & {"backend/ba.py", "backend/optimizer.py"}:
            return "window/solve"
        if "pipeline.py" in files:
            return "window/step"
        return "window/other"

    counting = count_syncs(torch, tag=tag)
    sync_at = counting.__enter__()
    try:
        while i < warm_end:
            states.append(slam.track([frames[i]], timestamp=i * 0.1)["state"])
            i += 1
        torch.cuda.synchronize()
        if not sync_check:
            counting.__exit__(None, None, None)
        n_warm_chunks = seen["chunk"] - chunks0
        log(f"{name}: warm-up frames {boot + 1}-{warm_end - 1} ({time.perf_counter() - t0:.2f} s, host syncs "
            f"counted): {n_warm_chunks} chunk boundaries, {seen['heavy']} heavy")
        per_chunk = sum(sync_at.values()) / max(n_warm_chunks, 1)
        log(f"{name}: host syncs per chunk boundary (warm-up, {n_warm_chunks} chunks of {FP_CHUNK} frames, the "
            f"chunk's steps included): {per_chunk:.1f}; by source line over the warm-up: "
            f"{dict(sync_at.most_common())}")

        heavy_before, chunks_before = seen["heavy"], seen["chunk"]
        call_ms = []
        torch.cuda.synchronize()
        timing["on"] = True
        t0 = time.perf_counter()
        for k in range(i, n_end):
            tc = time.perf_counter()
            states.append(slam.track([frames[k]], timestamp=k * 0.1)["state"])
            call_ms.append((time.perf_counter() - tc) * 1e3)
        slam.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        timing["on"] = False
    finally:
        if sync_check:
            counting.__exit__(None, None, None)
    cs_mod.to_host = fetch0
    n_chunks = max(seen["chunk"] - chunks_before, 1)
    per_chunk_ms = {k: round(v / n_chunks, 2) for k, v in stage_ms.items()}
    per_chunk_ms["other"] = round(dt * 1e3 / n_chunks - sum(stage_ms.values()) / n_chunks, 2)
    n_timed = n_end - i
    heavy_timed = seen["heavy"] - heavy_before
    launches = [fn.launches for fn in counters]
    ts, Ts = slam.trajectory()
    peak = torch.cuda.max_memory_allocated() / 2**20

    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=True)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    ate_pct = 100.0 * res["rmse"] / max(path_len, 1e-9)
    fps = n_timed / dt
    shapes = sorted(getattr(opt, "shapes_seen", set()))
    report = dict(fps=fps, ate_rmse=res["rmse"], ate_pct_of_path=ate_pct, frames_timed=n_timed,
                  keyframes=slam.map.num_keyframes(), landmarks=slam.map.num_map_points(),
                  ba_shapes=[f"{w}x{m}" for (w, m) in shapes], max_call_ms=max(call_ms),
                  heavy_in_window=heavy_timed, lost=states.count("LOST"), brute_recoveries=seen["brute"],
                  syncs_per_chunk=per_chunk, heavy_ms=heavy_ms, peak_mib=peak, chunk_ms=per_chunk_ms,
                  **heavy_summary(hc))
    if async_boundary:
        report.update(async_solve_device_ms=solve_device_ms(torch, hc["last_async"], cfg.optimization, dev))
        window = {k: v for k, v in sync_at.items() if k.startswith("window")}
        report.update(window_syncs=window, window_solve_syncs=sum(
            v for k, v in window.items() if k.startswith(("window/solve", "window/other"))))
        log(f"{name}: {json.dumps(report)}")
        log(f"{name}: async boundaries {hc['async_chunks']} (sync {hc['sync_chunks']}, cooloffs {hc['cooloffs']}, "
            f"landed with a correction {hc['corrections']}, largest |s - 1| {hc['max_scale_dev']:.3g}); "
            + ("no async boundary ran within the run's frames" if not hc["async_chunks"] else
               f"async solve start {report['async_start_ms_median']} ms and landing "
               f"{report['async_finish_ms_median']} ms of host time (medians), one solve on the side stream "
               f"{report['async_solve_device_ms']} ms of device time"))
        if sync_check:
            log(f"{name}: host syncs between an async solve's start and the next chunk's fetch, by where and source "
                f"line: {window} ({report['window_solve_syncs']} from the solve's or the boundary's code; the "
                f"step's run on the main stream, which the side stream's solve does not join, and a landing is "
                f"the next boundary's fetch of the solve)")
    log(f"{name}: FPS {fps:.2f} ({n_timed} frames timed in {dt:.3f} s, flush inside), ATE "
        f"{res['rmse']:.4f} m = {ate_pct:.3f} % of a {path_len:.2f} m path (scale-aligned), "
        f"{report['keyframes']} keyframes, {report['landmarks']} landmarks, ba_shapes {report['ba_shapes']}, "
        f"max_call_ms {report['max_call_ms']:.1f}")
    log(f"{name}: {seen['chunk']} chunks, {seen['heavy']} heavy boundaries ({heavy_timed} in the timed "
        f"window), ms per heavy boundary {[round(x, 1) for x in heavy_ms]}, LOST frames {report['lost']}, brute "
        f"recoveries {seen['brute']}, peak device memory {peak:.1f} MiB")
    log(f"{name} BA solves (cost0 -> cost, W x M): {[(c0, c, f'{w}x{m}') for c0, c, w, m in solves]}")
    log(f"{name} host ms per chunk in the timed window ({n_chunks} chunks of {FP_CHUNK} frames, "
        f"{dt * 1e3 / n_chunks:.1f} ms each): {per_chunk_ms}")

    # Launch counts: every detect (the initializer's and each step's) runs K1
    # once for all levels; every step and every tracker/brute-recovery match runs
    # K2; every step runs K3 against the arena.
    expected = [seen["detect"] + seen["step"], seen["match"] + seen["step"] + seen["brute_match"],
                seen["step"], 0, 0]
    log(f"{name} launches K1-K5: {launches} (expected {expected}: {seen['detect']} initializer detects, "
        f"{seen['step']} steps, {seen['match']} initializer matches, {seen['brute_match']} brute-recovery matches)")

    if report["lost"]:
        raise AssertionError(f"{report['lost']} frames went LOST: {states}")
    if not (len(ts) == n_end - boot and np.allclose(ts, 0.1 * np.arange(boot, n_end))):
        raise AssertionError(f"frames {boot}-{n_end - 1} should each have one pose, got timestamps {ts.tolist()}")
    if not np.isfinite(Ts).all():
        raise AssertionError("non-finite poses in the trajectory")
    bad = [(c0, c) for c0, c, _, _ in solves if not (np.isfinite(c0) and np.isfinite(c) and c <= c0)]
    if bad:
        raise AssertionError(f"BA solves not finite or ending above cost0: {bad}")
    if heavy_timed < 1 and not hc["async_chunks"]:
        raise AssertionError("the timed window holds no heavy boundary")
    if launches != expected:
        raise AssertionError(f"{name} launches K1-K5 {launches} != {expected}")
    if not ate_pct <= ate_max:
        raise AssertionError(f"{name}: ATE {ate_pct:.3f} % of path above {ate_max} %")
    if async_boundary and hc["side_stream"] and not all(hc["side_stream"]):
        raise AssertionError(f"{name}: an async solve did not run on the side stream")
    if sync_check and report["window_solve_syncs"]:
        raise AssertionError(f"{name}: host syncs of the solve or the boundary between an async solve's start and "
                             f"the next fetch: {report['window_syncs']}")

    if async_boundary:  # its first heavy boundaries are the sync run's, checked there
        return launches, report
    # The first heavy boundary's BA, packed problem solved again on the CPU.
    pending = first_heavy.get("pending")
    if pending is None:
        raise AssertionError("no BA ran at a heavy boundary")
    ocfg = cfg.optimization
    n1 = max(ocfg.n_iter // 2, 1)
    t0 = time.perf_counter()
    T_cpu, _, info_cpu = bundle_adjust_robust(to_device(pending["problem"], "cpu"), n_iter=n1,
                                              n_iter2=max(ocfg.n_iter - n1, 1), huber=ocfg.huber_delta / FOCAL,
                                              lam0=ocfg.lm_lambda0, trim_factor=3.0)
    cpu_s = time.perf_counter() - t0
    c_gpu, c_cpu = float(pending["info"]["cost"]), float(info_cpu["cost"])
    c0_gpu, c0_cpu = float(pending["info"]["cost0"]), float(info_cpu["cost0"])
    d_pose = float((pending["T"].cpu() - T_cpu).abs().max())
    log(f"first heavy BA ({pending['problem'].T_w2c.shape[0]}x{pending['problem'].points.shape[0]}, "
        f"{int(pending['problem'].obs_valid.sum())} observations), card vs CPU ({cpu_s:.2f} s): cost0 {c0_gpu:.6g} "
        f"vs {c0_cpu:.6g}, cost {c_gpu:.6g} vs {c_cpu:.6g}, poses max abs diff {d_pose:.2e}")
    if abs(c_gpu - c_cpu) > BA_COST_RTOL * abs(c_cpu) or abs(c0_gpu - c0_cpu) > BA_COST_RTOL * abs(c0_cpu):
        raise AssertionError(f"BA cost on the card {c0_gpu} -> {c_gpu} vs CPU {c0_cpu} -> {c_cpu}")
    if d_pose > BA_POSE_ATOL:
        raise AssertionError(f"BA poses on the card differ from the CPU's by {d_pose}")
    return launches, report


def facade_counters(slam, seen, stage_ms, timing):
    """Wrap the facade's stages: count the calls that launch a kernel
    (detects: K1; matches: K2; guided matches: K3; loop detects that reach
    the matcher: K4) and, while ``timing["on"]``, add each stage's host
    milliseconds to ``stage_ms``. Keyframe creation holds local mapping
    (synchronous mode); the report subtracts it. Returns a function that
    undoes the module-level wrap."""
    from visual_slam_tpu_torch import pipeline
    from visual_slam_tpu_torch.ops import guided_matching

    tr, lm, lh = slam.tracking, slam.local_mapping, slam.local_handler

    def wrap(owner, attr, stage=None, count=None):
        fn = getattr(owner, attr)

        def run(*a, **kw):
            if count:
                seen[count] += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if stage and timing["on"]:
                    stage_ms[stage] += (time.perf_counter() - t) * 1e3
        setattr(owner, attr, run)

    wrap(slam.feature_tracker, "detectAndCompute", "detect", "detect")
    wrap(slam.feature_tracker, "match", None, "match")
    wrap(tr, "_track_guided", "guided")
    wrap(tr, "_track_local_map", "local-map match")
    wrap(tr, "_optimize_pose", "PnP")
    wrap(tr, "_create_keyframe", "keyframe creation")
    wrap(tr, "_measure_depth", "depth")
    wrap(lm, "process_keyframe", "local mapping")
    wrap(lh, "step", "local BA")
    if slam.loop_closing is not None:
        lc = slam.loop_closing
        detect = lc.detect

        def loop_detect(kf):
            det = detect(kf)
            if lc.funnel:  # reached the matcher: one K4 launch
                seen["loop_match"] += 1
                seen.setdefault("funnels", []).append(
                    dict(kf=kf.keyframe_id, shortlist=len(lc.funnel["shortlist"]),
                         top_matches=sorted(lc.funnel["n_matches"], reverse=True)[:2],
                         inliers=list(lc.funnel["inliers"].values()),
                         candidate=None if det is None else det["candidate"].keyframe_id))
            return det
        lc.detect = loop_detect
    # Module and class level: the fused step (pipeline.FrameStep) detects
    # through TrackStep.detect and matches through pipeline.guided_match.
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in
             ((guided_matching, "guided_match"), (pipeline, "guided_match"), (pipeline.TrackStep, "detect"))]
    wrap(guided_matching, "guided_match", None, "guided")
    wrap(pipeline, "guided_match", None, "guided")
    wrap(pipeline.TrackStep, "detect", "detect", "detect")
    return lambda: [setattr(owner, attr, fn) for owner, attr, fn in saved]


def facade_run(torch, np, dev, counters, frames, K, Ts_gt, cfg, threaded=False, sync_frames=0, ransac_seed=None,
               baseline=0.0, frame_args=None):
    """One facade run over ``frames`` through ``SLAM.track``, the stages
    timed after the bootstrap; the host syncs counted by source line over
    the first ``sync_frames`` frames after it (those frames are left out of
    the timing). ``ransac_seed`` reseeds the tracker's RANSAC generator (13
    by default). A stereo or RGB-D run gives the camera's ``baseline`` and
    ``frame_args(i)`` -> (images, depth) of frame i (``frames`` then holds
    the left or gray images); it also reports the tracked frames' share of
    keypoint slots with a valid depth. Returns (slam, report)."""
    import facade_world as fw

    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.slam import SLAM
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    h, w = frames[0].shape
    gc.collect()  # the previous run's SLAM (its reference cycles hold device tensors)
    torch.cuda.reset_peak_memory_stats()
    slam = SLAM(PinholeCamera(width=w, height=h, K=np.asarray(K, np.float64), baseline=baseline), cfg,
                threaded=threaded, device=dev)
    if ransac_seed is not None:
        slam.tracking._gen.manual_seed(ransac_seed)
    seen, stage_ms, timing = collections.Counter(), collections.Counter(), {"on": False}
    unwrap = facade_counters(slam, seen, stage_ms, timing)
    for fn in counters:
        fn.launches = 0
    states, relocs, poses, sync_at, z_shares, guided_frames = [], 0, [], collections.Counter(), [], 0
    boot, t0, n_timed = None, None, 0
    for i, img in enumerate(frames):
        images, depth = frame_args(i) if frame_args is not None else ([img], None)
        counting = boot is not None and i <= boot + sync_frames
        with (count_syncs(torch) if counting else contextlib.nullcontext()) as syncs:
            info = slam.track(images, timestamp=i * fw.DT, depth=depth)
            if counting:
                torch.cuda.synchronize()
        if counting:
            sync_at.update(syncs)
        states.append(info["state"])
        relocs += bool(info.get("relocalized"))
        guided_frames += "n_guided" in info
        if info["state"] == "OK":
            poses.append((i * fw.DT, np.array(slam.tracking.last_frame.T_w2c)))
            cur = slam.tracking.current_frame
            if boot is not None and cur.kp_z_valid is not None:
                z_shares.append(float((cur.kp_z_valid & cur.valid_mask(0)).mean()))
        if boot is None and info["state"] == "OK":
            boot = i
        if boot is not None and i == boot + sync_frames:
            torch.cuda.synchronize()
            t0, timing["on"] = time.perf_counter(), True
        elif t0 is not None:
            n_timed += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0 if t0 is not None else 0.0
    timing["on"] = False
    t_sd = time.perf_counter()
    slam.shutdown()
    shutdown_s = time.perf_counter() - t_sd
    torch.cuda.synchronize()
    unwrap()
    launches = [fn.launches for fn in counters]
    res = {"states": states, "relocs": relocs, "poses": poses, "boot": boot if boot is not None else len(frames),
           "secs_after_boot": dt}
    report = fw.summary(slam, res, Ts_gt, ate_rmse)
    report.update(ransac_seed=13 if ransac_seed is None else ransac_seed, fps_after_boot=n_timed / dt if dt > 0 else 0.0, frames_timed=n_timed, shutdown_s=shutdown_s,
                  launches=launches[:4], detects=seen["detect"], matches=seen["match"], guided=seen["guided"],
                  loop_matches=seen["loop_match"], peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                  thread_failures=slam.local_mapping.failures + slam.local_handler.failures
                  + slam.global_handler.failures)
    if n_timed:
        ms = {k: v / n_timed for k, v in stage_ms.items()}
        if not threaded:  # inline local mapping runs inside keyframe creation
            ms["keyframe creation"] = ms.get("keyframe creation", 0.0) - ms.get("local mapping", 0.0)
        ms["total"] = dt * 1e3 / n_timed
        report["host_ms_per_frame"] = {k: round(v, 3) for k, v in ms.items()}
    if sync_frames:
        report["syncs_per_frame"] = sum(sync_at.values()) / sync_frames
        report["syncs_by_line"] = dict(sync_at.most_common(12))
    if "funnels" in seen:
        report["funnel"] = seen["funnels"]
    report["guided_frames"] = guided_frames
    if z_shares:
        report["kp_z_valid_frac"] = float(np.mean(z_shares))
    return slam, report


def check_facade_launches(name, r, tracked, guided_frames=None):
    """Each kernel's launches equal the wrapper calls of the run: K1 one per
    detect, K2 one per match, K3 one per guided association, K4 one per
    loop detect that reached the matcher. K1 runs at least once per tracked
    frame, K3 once per frame that tried the guided association
    (``guided_frames``; every tracked frame unless given); K2 at least once
    per keyframe after the bootstrap pair (local mapping matches each
    against its neighbours): a frame whose guided association holds takes
    no brute K2 match, by design in both packages."""
    expected = [r["detects"], r["matches"], r["guided"], r["loop_matches"]]
    if r["launches"] != expected:
        raise AssertionError(f"{name}: launches K1-K4 {r['launches']} != the run's calls {expected}")
    guided_frames = tracked if guided_frames is None else guided_frames
    if r["launches"][0] < tracked or r["launches"][2] < guided_frames or r["launches"][1] < r["keyframes"] - 2:
        raise AssertionError(f"{name}: K1/K2/K3 launched {r['launches'][:3]} times for {tracked} tracked frames and "
                             f"{r['keyframes']} keyframes")


def run_facade_phases(torch, np, dev, counters):
    """The host SLAM facade (``SLAM``) on the card: the deployment world
    (synchronous and threaded), the loop endurance world (loop closing on
    and off) and ``Processing`` over an in-memory source. Prints one JSON
    line per phase; returns the launches of ``counters`` summed over the
    phases; raises if a gate fails."""
    import facade_world as fw

    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.io import DataSourceBase

    total = [0] * len(counters)

    def add(launches):
        for k, n in enumerate(launches):
            total[k] += n

    def show(name, r):
        keep = {k: v for k, v in r.items() if k != "funnel"}
        log(json.dumps({"phase": name, **keep}, default=float))

    # 1. Deployment size, synchronous: the default RANSAC seed (timed, its
    # syncs counted), then the other seeds; each run classed, the gates
    # read the failed runs and the medians.
    frames, K, Ts = fw.deploy_frames(FACADE_FRAMES)
    deploy = []
    for seed in (None, *FACADE_SEEDS):
        t0 = time.perf_counter()
        slam, r = facade_run(torch, np, dev, counters, frames, K, Ts, fw.deploy_config(Config),
                             sync_frames=FACADE_SYNC if seed is None else 0, ransac_seed=seed)
        r["wall_s"] = time.perf_counter() - t0
        add(r["launches"] + [0])
        kf_pct = r.get("ate_keyframes", {}).get("pct", float("inf"))  # none under 3 keyframes
        r["outcome"] = ("LOST" if r["lost_after_boot"] else "scale jump" if kf_pct > FACADE_JUMP_PCT else "clean")
        show("facade_deploy", r)
        check_facade_launches("facade", r, len(frames) - r["boot_frame"] - 1 - r["lost_after_boot"])
        deploy.append(r)
    kf_ates = [r.get("ate_keyframes", {}).get("pct", float("inf")) for r in deploy]
    fr_ates = [r.get("ate_frames", {}).get("pct", float("inf")) for r in deploy]
    kf_ate, fr_ate = statistics.median(kf_ates), statistics.median(fr_ates)
    n_kf = statistics.median(r["keyframes"] for r in deploy)
    failed = [(r["ransac_seed"], r["outcome"]) for r in deploy if r["outcome"] != "clean"]
    log(json.dumps({"phase": "facade_deploy_seeds", "ransac_seeds": [r["ransac_seed"] for r in deploy],
                    "outcomes": [r["outcome"] for r in deploy], "lost_frames": [r["lost_after_boot"] for r in deploy],
                    "ate_keyframes_pct": kf_ates, "ate_frames_pct": fr_ates,
                    "keyframes": [r["keyframes"] for r in deploy], "failed_runs": failed,
                    "median_ate_keyframes_pct": kf_ate, "median_ate_frames_pct": fr_ate, "median_keyframes": n_kf}))
    if len(failed) > FACADE_JAX_FAILED_RUNS:
        raise AssertionError(f"facade: {len(failed)} of {len(deploy)} seeded runs failed {failed}, the JAX package "
                             f"fails {FACADE_JAX_FAILED_RUNS} at these seeds")
    if kf_ate > FACADE_KF_ATE_PCT_MAX or fr_ate > FACADE_FRAME_ATE_PCT_MAX:
        raise AssertionError(f"facade median ATE {kf_ate:.3f} % (keyframes) / {fr_ate:.3f} % (frames) above "
                             f"{FACADE_KF_ATE_PCT_MAX} / {FACADE_FRAME_ATE_PCT_MAX} %")
    if not FACADE_KF_RANGE[0] <= n_kf <= FACADE_KF_RANGE[1]:
        raise AssertionError(f"facade: median {n_kf} keyframes outside {FACADE_KF_RANGE}")

    # 2. Endurance: loop closing on and off.
    eframes, eK, eTs = fw.endurance_frames()
    ends = {}
    for loop_on in (True, False):
        slam, r = facade_run(torch, np, dev, counters, eframes, eK, eTs, fw.endurance_config(Config, loop_on))
        add(r["launches"] + [0])
        ends[loop_on] = r
        show(f"facade_endurance_loop_{'on' if loop_on else 'off'}", r)
        for f in r.get("funnel", []):
            log(f"  loop detect kf {f['kf']}: shortlist {f['shortlist']}, top matches {f['top_matches']}, "
                f"PnP inliers {f['inliers']}, candidate {f['candidate']}")
        if r["state"] != "OK":
            raise AssertionError(f"endurance (loop {loop_on}): final state {r['state']}")
        if r["relocalizations"] < 1:
            raise AssertionError(f"endurance (loop {loop_on}): no relocalization after the blackout")
        check_facade_launches("endurance", r, len(eframes) - r["boot_frame"] - 1 - r["lost_after_boot"])
    on, off = ends[True], ends[False]
    if on["closures"] < ENDURANCE_JAX_CLOSURES:
        raise AssertionError(f"endurance: {on['closures']} closures, the JAX package closed {ENDURANCE_JAX_CLOSURES}")
    if ENDURANCE_JAX_ON_BELOW_OFF and not on["ate_keyframes"]["pct"] < off["ate_keyframes"]["pct"]:
        raise AssertionError("endurance: ATE with loop closing not below ATE without, as the JAX package's was")
    if on["launches"][3] != on["loop_matches"] or on["loop_matches"] < 1:
        raise AssertionError(f"endurance: K4 launched {on['launches'][3]} times for {on['loop_matches']} detects")

    # 3. Threaded: the deployment world with local mapping and BA on
    # threads, THREADED_RUNS times (each interleaving is a new draw). Every
    # run: shutdown() within 30 s, no failed thread step. A run fails when
    # it has a LOST frame after the bootstrap, ends in another state than OK
    # or ends above the keyframe ATE gate; at most THREADED_FAILED_MAX may.
    threaded = []
    for _ in range(THREADED_RUNS):
        t0 = time.perf_counter()
        slam, r = facade_run(torch, np, dev, counters, frames, K, Ts, fw.deploy_config(Config), threaded=True)
        r["wall_s"] = time.perf_counter() - t0
        add(r["launches"] + [0])
        kf_pct = r.get("ate_keyframes", {}).get("pct", float("inf"))
        r["outcome"] = ("LOST" if r["lost_after_boot"] or r["state"] != "OK" else
                        "ATE above gate" if kf_pct > 2 * FACADE_KF_ATE_PCT_MAX else "clean")
        show("facade_threaded", r)
        if r["thread_failures"]:
            raise AssertionError(f"threaded: {r['thread_failures']} failed thread steps")
        if r["shutdown_s"] > 30.0:
            raise AssertionError(f"threaded: shutdown() took {r['shutdown_s']:.1f} s")
        threaded.append(r["outcome"])
    failed = [o for o in threaded if o != "clean"]
    log(json.dumps({"phase": "facade_threaded_runs", "outcomes": threaded, "failed": len(failed),
                    "failed_max": THREADED_FAILED_MAX}))
    if len(failed) > THREADED_FAILED_MAX:
        raise AssertionError(f"threaded: {len(failed)} of {THREADED_RUNS} runs failed {threaded}; at most "
                             f"{THREADED_FAILED_MAX} may (the JAX package's share)")

    # 4. Processing over an in-memory source with the KITTI P0 calibration.
    class Frames(DataSourceBase):
        def __init__(self, imgs):
            self.imgs, self.i = imgs, 0

        def get_frame(self):
            self.i += 1
            return self.imgs[self.i - 1], (self.i - 1) * fw.DT

        def is_ok(self):
            return self.i < len(self.imgs)

        def get_frame_shape(self):
            return self.imgs[0].shape

    out, states = run_processing(torch, np, dev, counters, Frames(frames[:PROCESSING_FRAMES]), K,
                                 fw.deploy_config(Config))
    add([fn.launches for fn in counters][:4] + [0])
    boot = next(i for i, (s, _) in enumerate(states) if s == "OK")
    posed = [T is not None and np.isfinite(T).all() for _, T in states[boot:]]
    log(json.dumps({"phase": "processing", **out, "boot_frame": boot, "posed_after_boot": int(sum(posed)),
                    "launches": [fn.launches for fn in counters][:4]}))
    if out["state"] != "OK" or out["frames"] != PROCESSING_FRAMES or not all(posed):
        raise AssertionError(f"processing: {out}, poses after the bootstrap {posed}")
    return total


class LaunchSum:
    """Two kernel wrappers' launch counts as one: K1 launches through
    ``patches_and_moments_levels`` (one frame) or ``patches_and_moments_batched``
    (a stereo pair as one B = 2 batch). Setting ``launches`` sets both."""

    def __init__(self, *fns):
        self.fns = fns

    @property
    def launches(self) -> int:
        return sum(fn.launches for fn in self.fns)

    @launches.setter
    def launches(self, n: int) -> None:
        for fn in self.fns:
            fn.launches = n


def check_stereo_pair(torch, np, dev, left, right):
    """A stereo pair through the detector as one B = 2 batch (the facade's
    detect) against two single detects on the card, at the stereo phase's
    width: keypoints (positions, octaves, sizes, validity) exact, responses
    and angles within 1e-5 (the pyramid's resize GEMMs may round a batch
    otherwise), at least PAIR_BIT_SHARE_MIN of the valid descriptor bits
    equal."""
    from visual_slam_tpu_torch.frontend.features import FastOrbFeature2D
    from visual_slam_tpu_torch.ops.orb import unpack_bits

    det = FastOrbFeature2D(num_features=N_FEATURES, n_levels=N_LEVELS, device=dev)
    pair = det.detectAndCompute(np.stack([left, right]).astype(np.float32))
    shares = []
    for b, img in enumerate((left, right)):
        one = det.detectAndCompute(img)
        for name in ("xy", "octave", "size", "valid"):
            if not torch.equal(getattr(pair, name)[b], getattr(one, name)):
                raise AssertionError(f"stereo pair: batched {name} of camera {b} differs from a single detect")
        for name in ("response", "angle"):
            torch.testing.assert_close(getattr(pair, name)[b], getattr(one, name), rtol=1e-5, atol=1e-5)
        ok = one.valid
        shares.append(float((unpack_bits(pair.desc[b])[ok] == unpack_bits(one.desc)[ok]).to(torch.float32).mean()))
    log(json.dumps({"phase": "stereo_pair_detect", "valid_keypoints": int(one.valid.sum()),
                    "desc_bit_share": shares, "min_share": PAIR_BIT_SHARE_MIN}))
    if min(shares) < PAIR_BIT_SHARE_MIN:
        raise AssertionError(f"stereo pair: batched descriptors agree on {shares} of the bits")


def run_depth_facade_phases(torch, np, dev, counters):
    """The stereo and RGB-D host facade (``SLAM``) on the card: each sensor's
    world at the default RANSAC seed and DEPTH_SEEDS with ``MonoTracking``,
    then one fused run, each classed and printed; then ``Processing`` over
    an in-memory source of each world. ``counters`` are the K1-K5 wrappers
    (K1 a ``LaunchSum`` of the one-frame and batched wrappers). Returns, per
    sensor, the launches summed over its phases by wrapper (``k1``, the
    one-frame K1; ``k1_batched``; ``k2``; ``k3``; ``k4``); raises if a gate
    fails."""
    import depth_world as dw

    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.io import DataSourceBase
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    k1 = counters[0]
    totals = {"stereo": collections.Counter(), "rgbd": collections.Counter()}

    def add(sensor, r):
        totals[sensor].update({"k1": r["k1_single"], "k1_batched": r["k1_batched"], "k2": r["launches"][1],
                               "k3": r["launches"][2], "k4": r["launches"][3]})

    t0 = time.perf_counter()
    lefts, rights, sK, sTs = dw.stereo_frames(STEREO_FRAMES)
    imgs, depths, rK, rTs = dw.rgbd_frames(RGBD_FRAMES)
    log(f"rendered the stereo ({len(lefts)} pairs, {lefts[0].shape}) and RGB-D ({len(imgs)} frames, "
        f"{imgs[0].shape}) worlds in {time.perf_counter() - t0:.2f} s")
    check_stereo_pair(torch, np, dev, lefts[0], rights[0])
    worlds = {
        "stereo": (lefts, sK, sTs, dw.stereo_config, dw.STEREO_BASELINE, lambda i: ([lefts[i], rights[i]], None)),
        "rgbd": (imgs, rK, rTs, dw.rgbd_config, 0.0, lambda i: ([imgs[i]], depths[i])),
    }
    for sensor, (frames, K, Ts, config, baseline, args) in worlds.items():
        runs = []
        for seed, fused in [(None, False)] + [(s, False) for s in DEPTH_SEEDS] + [(None, True)]:
            cfg = config(Config)
            cfg.tracking.fused_pipeline = fused
            t0 = time.perf_counter()
            sync = FACADE_SYNC if seed is None and not fused else 0  # the first run's syncs
            slam, r = facade_run(torch, np, dev, counters, frames, K, Ts, cfg, sync_frames=sync, ransac_seed=seed,
                                 baseline=baseline, frame_args=args)
            r["wall_s"] = time.perf_counter() - t0
            r["k1_single"], r["k1_batched"] = (fn.launches for fn in k1.fns)
            r["fused"] = fused
            r["ate_metric"] = dw.metric_ate(slam, Ts, ate_rmse)
            r["outcome"] = dw.classify(r["lost_after_boot"], r["ate_metric"], FACADE_JUMP_PCT)
            log(json.dumps({"phase": f"facade_{sensor}", **r}, default=float))
            add(sensor, r)
            # The one-frame bootstrap's landmarks carry no descriptors (as in
            # the JAX package): until the first keyframe mints some, a
            # MonoTracking frame has no guided association to try.
            tracked = len(frames) - r["boot_frame"] - 1 - r["lost_after_boot"]
            check_facade_launches(f"{sensor} facade", r, tracked, r["guided_frames"])
            # K1 once per frame: the pair as one batch in stereo.
            per_frame = (0, len(frames)) if sensor == "stereo" else (len(frames), 0)
            if (r["k1_single"], r["k1_batched"]) != per_frame:
                raise AssertionError(f"{sensor}: K1 launched {r['k1_single']} times alone and {r['k1_batched']} "
                                     f"times batched over {len(frames)} frames, not {per_frame}")
            if r["boot_frame"] != 0:
                raise AssertionError(f"{sensor}: bootstrap on frame {r['boot_frame']}, not 0")
            runs.append(r)
        seeded, fused_run = runs[:-1], runs[-1]
        failed = [(r["ransac_seed"], r["outcome"]) for r in seeded if r["outcome"] != "clean"]
        pcts = [r["ate_metric"]["pct"] if r["ate_metric"] else float("inf") for r in seeded]
        median = statistics.median(pcts)
        jax = DEPTH_JAX[sensor]
        failed_max = min(jax["failed"], DEPTH_PORT_CPU_FAILED[sensor])
        median_max = max(2 * jax["median_pct"], 2.0)
        log(json.dumps({"phase": f"facade_{sensor}_seeds", "ransac_seeds": [r["ransac_seed"] for r in seeded],
                        "outcomes": [r["outcome"] for r in seeded], "ate_metric_pct": pcts,
                        "scales": [r["ate_metric"] and r["ate_metric"]["scale"] for r in seeded],
                        "failed_runs": failed, "jax_failed_runs": jax["failed"],
                        "port_cpu_failed_runs": DEPTH_PORT_CPU_FAILED[sensor], "failed_max": failed_max,
                        "median_ate_metric_pct": median,
                        "median_max_pct": median_max, "fused_outcome": fused_run["outcome"],
                        "jax_fused_clean": jax["fused_clean"], "fps_after_boot": runs[0]["fps_after_boot"],
                        "detect_ms_per_frame": runs[0].get("host_ms_per_frame", {}).get("detect"),
                        "mono_facade_detect_ms": MONO_FACADE_DETECT_MS,
                        "syncs_per_frame": runs[0].get("syncs_per_frame"),
                        "kp_z_valid_frac": runs[0].get("kp_z_valid_frac"),
                        "jax_kp_z_valid_frac": jax["kp_z_valid_frac"],
                        "peak_mib": max(r["peak_mib"] for r in runs)}, default=float))
        if len(failed) > failed_max:
            raise AssertionError(f"{sensor}: {len(failed)} of {len(seeded)} seeded runs failed {failed}; at these "
                                 f"seeds the JAX package fails {jax['failed']}, the port on the CPU "
                                 f"{DEPTH_PORT_CPU_FAILED[sensor]}")
        if median > median_max:
            raise AssertionError(f"{sensor}: median metric keyframe ATE {median:.3f} % above {median_max:.3f} %")
        for r in runs:
            if r["outcome"] == "clean" and not DEPTH_SCALE_RANGE[0] < r["ate_metric"]["scale"] < DEPTH_SCALE_RANGE[1]:
                raise AssertionError(f"{sensor}: fitted scale {r['ate_metric']['scale']:.4f} outside "
                                     f"{DEPTH_SCALE_RANGE}")
        if fused_run["outcome"] != "clean":
            raise AssertionError(f"{sensor}: the fused run is {fused_run['outcome']}, not clean")

    # Processing over in-memory sources: KITTI's P0/P1 calibration with the
    # stereo pairs; TUM1's K with the RGB-D frames and their depth maps.
    class Frames(DataSourceBase):
        def __init__(self, frames, depths=None):
            self.frames, self.depths, self.i = frames, depths, 0

        def get_frame(self):
            self.i += 1
            return self.frames[self.i - 1], (self.i - 1) * dw.DT

        def get_depth(self, ts):
            return self.depths[int(round(ts / dw.DT))]

        def is_ok(self):
            return self.i < len(self.frames)

        def get_frame_shape(self):
            f = self.frames[0]
            return (f[0] if isinstance(f, list) else f).shape

    n = DEPTH_PROCESSING_FRAMES
    bf = dw.STEREO_BASELINE * sK[0, 0]
    sources = {
        "stereo": (Frames([[lefts[i], rights[i]] for i in range(n)]), sK, -bf, dw.stereo_config),
        "rgbd": (Frames(imgs[:n], depths[:n]), rK, None, dw.rgbd_config),
    }
    for sensor, (source, K, p1, config) in sources.items():
        out, states = run_processing(torch, np, dev, counters, source, K, config(Config), p1)
        r = {"k1_single": k1.fns[0].launches, "k1_batched": k1.fns[1].launches,
             "launches": [fn.launches for fn in counters][:4]}
        add(sensor, r)
        boot = next((i for i, (s, _) in enumerate(states) if s == "OK"), None)
        posed = [T is not None and np.isfinite(T).all() for _, T in states[boot or 0:]]
        log(json.dumps({"phase": f"processing_{sensor}", **out, "boot_frame": boot, "posed_after_boot": int(sum(posed)),
                        "launches": r["launches"], "k1_single": r["k1_single"], "k1_batched": r["k1_batched"]}))
        if out["state"] != "OK" or boot != 0 or out["frames"] != n or not all(posed):
            raise AssertionError(f"processing ({sensor}): {out}, bootstrap on frame {boot}, poses {posed}")
    return totals


def run_processing(torch, np, dev, counters, source, K, cfg, p1_tx=None):
    """``Processing`` over ``source`` with a KITTI ``calib.txt`` holding K as
    P0 and, for stereo, P1 with ``p1_tx`` (-baseline x fx) as its fourth
    entry. Returns (run()'s result, (state, T_w2c or None) per frame); the
    counters are zeroed first."""
    import tempfile

    from visual_slam_tpu_torch.processing import Processing

    for fn in counters:
        fn.launches = 0
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        calib = Path(d) / "calib.txt"
        rows = [f"P0: {K[0, 0]} 0 {K[0, 2]} 0 0 {K[1, 1]} {K[1, 2]} 0 0 0 1 0"]
        if p1_tx is not None:
            rows.append(f"P1: {K[0, 0]} 0 {K[0, 2]} {p1_tx} 0 {K[1, 1]} {K[1, 2]} 0 0 0 1 0")
        calib.write_text("\n".join(rows) + "\n")
        proc = Processing(source, calib, cfg, device=dev)
    slam = proc.slam
    states = []
    track = slam.track

    def track_logged(images, ts, depth=None):
        info = track(images, ts, depth=depth)
        states.append((info["state"], np.array(slam.tracking.last_frame.T_w2c) if info["state"] == "OK" else None))
        return info

    slam.track = track_logged
    out = proc.run()
    torch.cuda.synchronize()
    return out, states


def watch_loop_closing(torch, slam, stats):
    """Time LoopClosing's detect and close on ``slam`` and, inside close,
    the Sim(3) pose-graph solve and the global BA; keep each detect's
    funnel and each closure."""
    from visual_slam_tpu_torch.loop_closing import loop_closing as lc_mod

    lc = slam.loop_closing
    detect0, close0 = lc.detect, lc.close

    def detect(kf):
        t = time.perf_counter()
        det = detect0(kf)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        stats["detect_ms"].append(ms)
        if lc.funnel:
            f = lc.funnel
            stats["funnels"].append(dict(kf=kf.keyframe_id, frame=int(round(kf.timestamp / LP_DT)), ms=round(ms, 2),
                                         shortlist=len(f["shortlist"]), top=sorted(f["n_matches"], reverse=True)[:2],
                                         inliers=list(f["inliers"].values()),
                                         candidate=None if det is None else det["candidate"].keyframe_id))
        return det

    def close(kf, det, use_sim3=True):
        solve0, global0 = lc_mod.optimize_sim3_graph, lc.map.optimize_global
        part = {}

        def solve(*a, **k):
            t = time.perf_counter()
            out = solve0(*a, **k)
            torch.cuda.synchronize()
            part["pose_graph_ms"] = (time.perf_counter() - t) * 1e3
            return out

        def global_ba(*a, **k):
            t = time.perf_counter()
            out = global0(*a, **k)
            torch.cuda.synchronize()
            part["global_ba_ms"] = (time.perf_counter() - t) * 1e3
            return out

        lc_mod.optimize_sim3_graph, lc.map.optimize_global = solve, global_ba
        t = time.perf_counter()
        try:
            res = close0(kf, det, use_sim3)
            torch.cuda.synchronize()
        finally:
            lc_mod.optimize_sim3_graph = solve0
            del lc.map.optimize_global
        stats["closures"].append(dict(kf=kf.keyframe_id, candidate=det["candidate"].keyframe_id,
                                      frame=int(round(kf.timestamp / LP_DT)), n_matches=det["n_matches"],
                                      n_inliers=det["n_inliers"], s_meas=det["s_meas"],
                                      close_ms=(time.perf_counter() - t) * 1e3, cost=res["pose_graph_cost"], **part))
        return res

    lc.detect, lc.close = detect, close


def loop_pass(torch, np, slam, frames, T_gt, counters, name, start=0, warm_end=None, save=None):
    """Drive ``slam`` through ``frames[start:]`` (the bootstrap first when it
    is not OK yet), timing after ``warm_end`` (host syncs per chunk counted
    before it) with ``flush()`` inside the clock; ``save`` = (frame, path)
    checkpoints after that frame (flushed; the save stays off the clock).
    The report carries ``heavy_counters``' summary. Returns the pass's
    report; raises if no kernel of K1-K3 launched."""
    import loop_pipeline_world as lpw

    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    stats = collections.defaultdict(list)
    if slam.loop_closing is not None:
        watch_loop_closing(torch, slam, stats)
    chunks = collections.Counter()
    run_chunk0 = slam._run_chunk

    def run_chunk():
        chunks["n"] += 1
        return run_chunk0()

    slam._run_chunk = run_chunk
    hc = heavy_counters(slam)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    states, report, i = [], dict(phase="loop_pipeline", run=name), start
    n_before = slam.num_frames_tracked()
    t0 = time.perf_counter()
    while slam.state.name != "OK" and i < 16:
        states.append(slam.track([frames[i]], timestamp=i * LP_DT)["state"])
        i += 1
    if slam.state.name != "OK":
        raise AssertionError(f"loop pipeline {name}: bootstrap failed after {i} frames")
    if i > start:
        report.update(bootstrap_frame=i - 1, bootstrap_s=time.perf_counter() - t0)
    warm_end = i if warm_end is None else warm_end(i)
    c0 = chunks["n"]
    with count_syncs(torch) as sync_at:
        while i < warm_end:
            states.append(slam.track([frames[i]], timestamp=i * LP_DT)["state"])
            i += 1
        torch.cuda.synchronize()
    if chunks["n"] > c0:
        report["syncs_per_chunk"] = sum(sync_at.values()) / (chunks["n"] - c0)
    torch.cuda.synchronize()
    t_clock, n_timed = time.perf_counter(), len(frames) - i
    for k in range(i, len(frames)):
        states.append(slam.track([frames[k]], timestamp=k * LP_DT)["state"])
        if save is not None and k == save[0]:
            slam.flush()
            torch.cuda.synchronize()
            t = time.perf_counter()
            slam.save(save[1])
            save_ms = (time.perf_counter() - t) * 1e3
            t_clock += save_ms / 1e3
            report.update(checkpoint_frame=k, checkpoint_chunk_end=not slam._chunk_buf, save_ms=save_ms,
                          checkpoint_bytes=sum(p.stat().st_size for p in Path(save[1]).iterdir()),
                          saved_keyframes=slam.map.num_keyframes(), saved_landmarks=slam.map.num_map_points(),
                          closures_before_checkpoint=len(stats["closures"]))
    slam.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_clock
    launches = [fn.launches for fn in counters]
    ts, Tw = slam.trajectory()
    n_poses = n_before + len(frames) - report.get("bootstrap_frame", start)
    if not (np.isfinite(Tw).all() and len(ts) == n_poses):
        raise AssertionError(f"loop pipeline {name}: {len(ts)} poses (expected {n_poses}), finite "
                             f"{np.isfinite(Tw).all()}")
    rmse, pct = lpw.ate_pct(ate_rmse, ts, Tw, T_gt)
    report.update(fps=n_timed / dt, frames_timed=n_timed, ate_m=rmse, ate_pct_of_path=pct,
                  lost=states.count("LOST"), state=slam.state.name, keyframes=slam.map.num_keyframes(),
                  landmarks=slam.map.num_map_points(), chunks=chunks["n"],
                  closures=stats["closures"], detects=len(stats["detect_ms"]),
                  detect_ms_median=statistics.median(stats["detect_ms"]) if stats["detect_ms"] else None,
                  launches_k1_k5=launches, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                  **heavy_summary(hc))
    for f in stats["funnels"]:
        log(f"loop pipeline {name}: detect at kf {f['kf']} (frame {f['frame']}) {f['ms']} ms, shortlist "
            f"{f['shortlist']}, top-2 matches {f['top']}, PnP inliers {f['inliers']}, candidate {f['candidate']}")
    log(json.dumps(report))
    if min(launches[:3]) < 1:
        raise AssertionError(f"loop pipeline {name}: K1-K3 launches {launches[:3]}")
    return report


def run_loop_pipeline(torch, np, dev, counters):
    """bench_loop_pipeline's deployment through the port's entry points, on
    the card: the 200-frame KITTI-width ring with loop closing on (saving a
    checkpoint after LP_CHECKPOINT) and off, a new system resumed from that
    checkpoint, and, where the JAX package's on pass closes no loop, the
    small ring where its test asserts one. Returns (launches of ``counters``
    over the phase, K4's launches, and the arguments of the on pass's K4
    call with the most real candidate blocks); raises if a gate fails."""
    import shutil
    import tempfile

    import loop_pipeline_world as lpw

    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.map import KeyFrame
    from visual_slam_tpu_torch.map.frame import FrameBase
    from visual_slam_tpu_torch.models import CompiledSLAM
    from visual_slam_tpu_torch.ops import matching

    t0 = time.perf_counter()
    frames, K, T_gt = lpw.loop_frames()
    log(f"loop pipeline world: {len(frames)} frames {frames.shape[1:]}, {lpw.N_SPRITES} sprites, noise "
        f"{lpw.NOISE}, brightness drift {lpw.BRIGHT}, rendered in {time.perf_counter() - t0:.2f} s")
    cam = PinholeCamera(width=lpw.WIDTH, height=lpw.HEIGHT, K=K)
    total = [0] * len(counters)
    ckpt = Path(tempfile.mkdtemp(prefix="loop_ckpt_"))
    captured = []
    top2_batched0 = matching.hamming_top2_batched

    def capture(*args):
        # The call with the most real candidate blocks: a full shortlist.
        real = int(args[3].any(1).sum())
        if not captured or real > captured[0]:
            captured[:] = [real, [a.clone() for a in args]]
        return top2_batched0(*args)

    try:
        # On, with the checkpoint; a K4 call's arguments kept.
        matching.hamming_top2_batched = capture
        try:
            on = loop_pass(torch, np, CompiledSLAM(cam, lpw.loop_config(Config, True), device=dev), frames, T_gt,
                           counters, "on", warm_end=lambda i: lpw.warm_end(i, len(frames)),
                           save=(LP_CHECKPOINT, ckpt))
        finally:
            matching.hamming_top2_batched = top2_batched0
        off = loop_pass(torch, np, CompiledSLAM(cam, lpw.loop_config(Config, False), device=dev), frames, T_gt,
                        counters, "off", warm_end=lambda i: lpw.warm_end(i, len(frames)))
        total = [a + b for a, b in zip(on["launches_k1_k5"], off["launches_k1_k5"])]
        # Resume as a new process would: the id counters restart at 0.
        with FrameBase._ids_lock:
            FrameBase._ids = itertools.count(0)
        with KeyFrame._kf_ids_lock:
            KeyFrame._kf_ids = itertools.count(0)
        t = time.perf_counter()
        slam = CompiledSLAM.resume(ckpt, cam, device="cuda")
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t) * 1e3
        restored = (slam.map.num_keyframes(), slam.map.num_map_points())
        on_features_on_card = all(t.device.type == "cuda" for kf in slam.map.get_keyframes()
                                  for t in kf.get_features(0))
        res = loop_pass(torch, np, slam, frames, T_gt, counters, "resume", start=LP_CHECKPOINT + 1)
        total = [a + b for a, b in zip(total, res["launches_k1_k5"])]
        log(f"loop pipeline resume: checkpoint {on['checkpoint_bytes']} bytes after frame {LP_CHECKPOINT} "
            f"(chunk end {on['checkpoint_chunk_end']}), save {on['save_ms']:.1f} ms, resume {resume_ms:.1f} ms, "
            f"restored {restored[0]} keyframes and {restored[1]} landmarks (saved {on['saved_keyframes']} and "
            f"{on['saved_landmarks']}), every feature block on the card {on_features_on_card}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    small = None
    if LP_JAX["on_closures"] == 0:
        small_frames, K_s, T_s = lpw.small_ring_frames()
        h, w = small_frames[0].shape
        small = loop_pass(torch, np, CompiledSLAM(PinholeCamera(width=w, height=h, K=K_s),
                                                  lpw.small_ring_config(Config), device=dev),
                          small_frames, T_s, counters, "small")
        total = [a + b for a, b in zip(total, small["launches_k1_k5"])]
    # The heavy boundary's modes on the ring, loop closing on: async
    # boundaries at their default gates, then the sparse landmark-major BA
    # (sparse_obs="auto": every solve of this configuration, whose pose
    # bucket floor is 32, and one more global BA over the final map, timed).
    modes = {}
    for mode in ("async", "sparse"):
        cfg = lpw.loop_config(Config, True)
        if mode == "async":
            cfg.tracking.async_boundary = True
        else:
            cfg.optimization.sparse_obs = "auto"
        slam = CompiledSLAM(cam, cfg, device=dev)
        modes[mode] = loop_pass(torch, np, slam, frames, T_gt, counters, mode,
                                warm_end=lambda i: lpw.warm_end(i, len(frames)))
        total = [a + b for a, b in zip(total, modes[mode]["launches_k1_k5"])]
        if mode == "sparse":
            layouts = []
            start0 = slam.optimizer.solve_start

            def solve_start(*a, **k):
                pending = start0(*a, **k)
                layouts.append(pending["sparse"])
                return pending

            slam.optimizer.solve_start = solve_start
            torch.cuda.synchronize()
            t = time.perf_counter()
            ga = slam.map.optimize_global(slam.optimizer)
            torch.cuda.synchronize()
            modes[mode].update(final_global_ba_ms=(time.perf_counter() - t) * 1e3, final_global_ba_sparse=layouts,
                               final_global_ba_shape=sorted(slam.optimizer.shapes_seen)[-1],
                               final_global_ba_cost=(ga.get("cost0"), ga.get("cost")))
            log(f"loop pipeline sparse: one global BA over the final map ({slam.map.num_keyframes()} keyframes, "
                f"{slam.map.num_map_points()} landmarks) in {modes[mode]['final_global_ba_ms']:.1f} ms, layouts "
                f"{layouts}, cost {modes[mode]['final_global_ba_cost']}")

    # Gates (section 4 of the phase's description in the module docstring).
    fails = []
    for r in (on, off, res):
        if r["lost"]:
            fails.append(f"{r['run']}: {r['lost']} LOST frames")
    for r in (on, res):
        if r["state"] != "OK":
            fails.append(f"{r['run']}: state {r['state']} at the end")
    if LP_JAX["on_closures"] > 0 and len(on["closures"]) < LP_JAX["on_closures"]:
        fails.append(f"on: {len(on['closures'])} closures, JAX's on pass {LP_JAX['on_closures']}")
    if small is not None and (small["state"] != "OK" or not small["closures"]):
        fails.append(f"small ring: {len(small['closures'])} closures, state {small['state']}")
    on_max = max(2 * LP_JAX["on_ate_pct"], LP_ATE_PCT_FLOOR)
    off_max = max(2 * LP_JAX["off_ate_pct"], LP_ATE_PCT_FLOOR)
    res_max = max(2 * on["ate_pct_of_path"], LP_ATE_PCT_FLOOR)
    for r, lim in ((on, on_max), (off, off_max), (res, res_max)):
        if not r["ate_pct_of_path"] <= lim:
            fails.append(f"{r['run']}: ATE {r['ate_pct_of_path']:.3f} % of path above {lim:.3f} %")
    if on["launches_k1_k5"][3] < 1:
        fails.append("on: K4 never launched")
    if off["launches_k1_k5"][3] != 0:
        fails.append(f"off: K4 launched {off['launches_k1_k5'][3]} times")
    if restored != (on["saved_keyframes"], on["saved_landmarks"]):
        fails.append(f"resume: restored {restored}, saved {(on['saved_keyframes'], on['saved_landmarks'])}")
    if not on_features_on_card:
        fails.append("resume: a restored feature block is not on the card")
    if any(c["frame"] > LP_CHECKPOINT for c in on["closures"]) and not res["closures"]:
        fails.append("resume: no closure after resuming, where the uninterrupted on pass closed after the checkpoint")
    log(f"loop pipeline: ATE on {on['ate_pct_of_path']:.3f} % (gate {on_max:.3f}), off {off['ate_pct_of_path']:.3f} % "
        f"(gate {off_max:.3f}), resumed {res['ate_pct_of_path']:.3f} % (gate {res_max:.3f}); FPS on {on['fps']:.2f}, "
        f"off {off['fps']:.2f}, resumed {res['fps']:.2f}; closures on {len(on['closures'])}, resumed "
        f"{len(res['closures'])}, small ring {None if small is None else len(small['closures'])}; launches K1-K5 "
        f"{total}")
    for mode, r in modes.items():
        lim = max(2 * LP_JAX[f"{mode}_ate_pct"], LP_ATE_PCT_FLOOR)
        if r["lost"] or r["state"] != "OK":
            fails.append(f"{mode}: {r['lost']} LOST frames, state {r['state']}")
        if not r["ate_pct_of_path"] <= lim:
            fails.append(f"{mode}: ATE {r['ate_pct_of_path']:.3f} % of path above {lim:.3f} %")
        if r["launches_k1_k5"][3] < 1:
            fails.append(f"{mode}: K4 never launched")
    if not modes["async"]["async_chunks"]:
        fails.append("async: no async boundary ran")
    if not (modes["async"]["side_stream"] is not False):
        fails.append("async: an async solve did not run on the side stream")
    sp = modes["sparse"]
    # Every solve from the sparse_auto_min_window bucket on is sparse (the
    # bootstrap's two-view solve, bucket 2, stays dense by the same rule).
    min_w = lpw.loop_config(Config, True).optimization.sparse_auto_min_window
    if any(w >= min_w for w in sp["dense_buckets"]) or not sp["solves_sparse"] or not all(sp["closing_ba_sparse"]):
        fails.append(f"sparse: dense solves at pose buckets {sp['dense_buckets']}, sparse {sp['solves_sparse']}, "
                     f"closing BA {sp['closing_ba_sparse']}")
    if sp["final_global_ba_sparse"] != [True]:
        fails.append(f"sparse: the final global BA's layouts {sp['final_global_ba_sparse']}")
    for mode, r in modes.items():
        cl = r["closures"]
        ba_ms = [round(c.get("global_ba_ms", 0), 1) for c in cl]
        dense_ms = [round(c.get("global_ba_ms", 0), 1) for c in on["closures"]]
        log(f"loop pipeline {mode}: closures at frames {[c['frame'] for c in cl]} (global BA ms {ba_ms}, dense on "
            f"pass {dense_ms}), "
            f"ATE {r['ate_pct_of_path']:.3f} % (gate {max(2 * LP_JAX[f'{mode}_ate_pct'], LP_ATE_PCT_FLOOR):.3f}), FPS "
            f"{r['fps']:.2f} (dense sync on pass {on['fps']:.2f}), async boundaries {r['async_chunks']}, landed "
            f"corrections {r['corrections']} (largest |s - 1| {r['max_scale_dev']:.3g}), K4 launches "
            f"{r['launches_k1_k5'][3]}, solves dense / sparse {r['solves_dense']} / {r['solves_sparse']}")
    if fails:
        raise AssertionError("loop pipeline gates: " + "; ".join(fails))
    k4 = sum(r["launches_k1_k5"][3] for r in (on, res, small, *modes.values()) if r)
    return total, k4, captured[1] if captured else None


def run_ba_layouts(torch, np, dev) -> list[dict]:
    """Dense against sparse landmark-major BA at scripts/bench_ba_sparse.py's
    shapes (BA_SHAPES; its problem, rebuilt in numpy by tests/ba_world.py):
    ``bundle_adjust`` and ``bundle_adjust_sparse`` with 20 LM iterations,
    host+device wall of a synchronised solve (median and min of BA_REPS
    after one warm-up), device ms (CUDA events around BA_REPS back-to-back
    solves), host syncs inside one solve, both final costs and the largest
    pose difference. Fails on a non-finite or rising cost, a sparse cost
    more than BA_COST_RTOL from the dense one, or a host sync inside a
    solve. Returns one dict per shape."""
    import ba_world

    from visual_slam_tpu_torch.backend.ba import BAProblem, BASparse, bundle_adjust, bundle_adjust_sparse
    from visual_slam_tpu_torch.utils.tree import to_device

    rows = []
    for W_, M, K in BA_SHAPES:
        dense, sparse = ba_world.make_problem(W_, M, K)
        row = dict(phase="ba_layouts", W=W_, M=M, K=K, n_obs=int(dense["obs_valid"].sum()))
        poses = {}
        for layout, solve, problem in (("dense", bundle_adjust, to_device(BAProblem(**dense), dev)),
                                       ("sparse", bundle_adjust_sparse, to_device(BASparse(**sparse), dev))):
            fn = lambda: solve(problem, n_iter=20)  # noqa: E731
            med, mn = timed(fn, reps=BA_REPS, warmup=1)
            dms, gapless = device_ms(fn, n=BA_REPS, warmup=1)
            torch.cuda.synchronize()
            with count_syncs(torch) as syncs:
                T, _, info = fn()
            torch.cuda.synchronize()
            c0, c = float(info["cost0"]), float(info["cost"])
            poses[layout] = T.cpu().numpy()
            row.update({f"{layout}_ms": med, f"{layout}_ms_min": mn, f"{layout}_device_ms": dms,
                        f"{layout}_device_gapless": gapless,
                        f"{layout}_syncs": sum(syncs.values()), f"{layout}_cost0": c0, f"{layout}_cost": c})
            if not (np.isfinite(c) and c <= c0):
                raise AssertionError(f"BA {layout} {W_}x{M}x{K}: cost {c0} -> {c}")
            if syncs:
                raise AssertionError(f"BA {layout} {W_}x{M}x{K}: host syncs inside the solve {dict(syncs)}")
        row["max_pose_diff"] = float(np.abs(poses["dense"] - poses["sparse"]).max())
        rows.append(row)
        log(f"BA W={W_} M={M} K={K} ({row['n_obs']} observations, 20 iterations): dense {row['dense_ms']:.2f} ms "
            f"(device {row['dense_device_ms']:.2f}), sparse {row['sparse_ms']:.2f} ms (device "
            f"{row['sparse_device_ms']:.2f}); syncs per solve {row['dense_syncs']} / {row['sparse_syncs']}; cost "
            f"{row['dense_cost']:.6g} / {row['sparse_cost']:.6g}; poses differ by {row['max_pose_diff']:.2e}")
        if abs(row["sparse_cost"] - row["dense_cost"]) > BA_COST_RTOL * abs(row["dense_cost"]):
            raise AssertionError(f"BA {W_}x{M}x{K}: sparse cost {row['sparse_cost']} vs dense {row['dense_cost']}")
    log(json.dumps({"ba_layouts": rows}))
    return rows


def run_pose_graphs(torch, np, dev):
    """bench_pose_graph's SE(3) problem and a drifted Sim(3) loop, both at
    PG_NODES: the cost must fall; ms per solve after one warm-up."""
    import loop_world as lw

    from visual_slam_tpu_torch.loop_closing import pose_graph as pg

    poses, loops = lw.bench_pose_graph_problem(PG_NODES, PG_LOOPS)
    g = pg.build_sequential_graph(poses, loops, device=dev)
    se3 = lambda: pg.optimize_pose_graph(g, n_iter=PG_ITERS)  # noqa: E731
    spose, sloops, gt = lw.sim3_loop_problem(PG_NODES, PG_LOOPS)
    g3 = pg.build_sim3_graph(spose, sloops, device=dev)
    sim3 = lambda: pg.optimize_sim3_graph(g3, n_iter=PG_ITERS)  # noqa: E731
    for name, solve in (("SE(3) bench_pose_graph", se3), ("Sim(3) drifted loop", sim3)):
        t0 = time.perf_counter()
        out = solve()
        costs = out[-1]["costs"].cpu().numpy()
        first = (time.perf_counter() - t0) * 1e3
        if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
            raise AssertionError(f"{name}: cost did not fall: {costs}")
        ms = timed(solve, reps=5, warmup=1)
        extra = ""
        if name.startswith("Sim"):
            extra = (f", keyframe ATE {lw.keyframe_ate(spose.astype(np.float64), gt):.4f} -> "
                     f"{lw.keyframe_ate(out[0].cpu().numpy().astype(np.float64), gt):.4f} m")
        log(f"pose graph {name}, {PG_NODES} nodes, {PG_LOOPS} loops, {PG_ITERS} iterations: cost {costs[0]:.6g} -> "
            f"{costs[-1]:.6g}{extra}; median {ms[0]:.2f} ms min {ms[1]:.2f} ms per solve (first call "
            f"{first:.1f} ms, with the one-time imports and solver set-up)")
    # Recorded, not gated: the reference's Sim(3) solver diverges on
    # bench_pose_graph's own problem (tests/test_torch_loop_closing.py
    # holds the port to the same divergence on the CPU).
    bench3 = pg.build_sim3_graph(poses, [(i, j, T, 1.0) for i, j, T in loops], device=dev)
    costs = pg.optimize_sim3_graph(bench3, n_iter=PG_ITERS)[-1]["costs"].cpu().numpy()
    log(f"pose graph Sim(3) bench_pose_graph, {PG_NODES} nodes, {PG_LOOPS} loops, {PG_ITERS} iterations: "
        f"costs {costs.tolist()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; this script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import render as render_mod

    from visual_slam_tpu_torch import _build, pipeline
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import (
        extract_patches32,
        patches_and_moments_batched,
        patches_and_moments_levels,
    )

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, ctypes) -> {_build.LIB.relative_to(ROOT)}")

    t0 = time.perf_counter()
    K, Ts, frames, zbuf = make_world_frames(render_mod, np)
    log(f"rendered {len(frames)} frames {frames.shape[1:]} in {time.perf_counter() - t0:.2f} s")

    rows = check_kernels(torch, np, frames[1], K) + check_batched_kernels(torch, np, list(frames[1:1 + MS_B]))
    # The batched K1 at the stereo facade's B = 2: the first pair of its world.
    import depth_world as dw

    lefts, rights, _, _ = dw.stereo_frames(1)
    rows.append(batched_k1_row(torch, np, [lefts[0], rights[0]], "patches_and_moments_batched, B = 2 stereo pair"))
    # K1, K2 and K3 at the RGB-D facade's shapes: its world's first frame.
    from visual_slam_tpu_torch.config import Config

    rgbd_rows = check_rgbd_kernels(torch, np, dw.rgbd_frames(1)[0][0], dw.rgbd_config(Config).feature.num_features)
    rows += rgbd_rows

    dev = torch.device("cuda")
    kw = dict(num_features=N_FEATURES, n_levels=N_LEVELS, grid=GRID, pnp_hypotheses=N_HYP,
              local_map=True, width=W, height=H)
    step = pipeline.make_track_step(K, device=dev, **kw)
    chunk = pipeline.make_track_chunk(step)
    make_state, n_lm = initial_state(torch, np, step, frames[0], zbuf, K, dev)
    imgs = torch.from_numpy(frames[1:]).to(dev)
    log(f"arena: {n_lm} landmarks from frame 0 in {ARENA} slots")

    # The tracking path, counted: two chunks of 8 frames.
    counters = (patches_and_moments_levels, mk.hamming_top2, mk.guided_top2, mk.hamming_top2_batched, extract_patches32)
    for fn in counters:
        fn.launches = 0
    state = make_state()
    outs = []
    for c in range(N_CHUNKS):
        state, o = chunk(state, imgs[c * CHUNK:(c + 1) * CHUNK])
        outs.append(o)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    n_frames = CHUNK * N_CHUNKS
    expected = [n_frames, n_frames, n_frames, 0, 0]
    log(f"tracking path launches K1-K5: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} != {expected}")

    T = torch.cat([o.T_w2c for o in outs]).cpu().numpy()
    n_inl = torch.cat([o.n_inliers for o in outs]).cpu().numpy()
    n_guided = torch.cat([o.guided_valid.sum(-1) for o in outs]).cpu().numpy()
    n_match = torch.cat([o.n_matches for o in outs]).cpu().numpy()
    err_R = np.abs(T[:, :3, :3] - Ts[1:, :3, :3]).max(axis=(1, 2))
    err_t = np.abs(T[:, :3, 3] - Ts[1:, :3, 3]).max(axis=1)
    for i in range(n_frames):
        log(f"frame {i + 1:2d}: inliers {int(n_inl[i]):4d} ref matches {int(n_match[i]):4d} "
            f"guided {int(n_guided[i]):4d} |dR| {err_R[i]:.5f} |dt| {err_t[i]:.4f} m")
    if not np.isfinite(T).all() or T.shape != (n_frames, 4, 4):
        raise AssertionError("non-finite or misshapen poses")
    if (n_inl < MIN_INLIERS).any():
        raise AssertionError(f"frames below {MIN_INLIERS} inliers: {np.nonzero(n_inl < MIN_INLIERS)[0] + 1}")
    if (err_R[:CHUNK] > R_ATOL).any() or (err_t[:CHUNK] > T_ATOL).any():
        raise AssertionError(f"first chunk off ground truth: R {err_R[:CHUNK].max()} t {err_t[:CHUNK].max()}")

    # Host synchronisations inside one step, by source line of the port
    # (informational: linalg.eigh/svd read their error status back).
    s = make_state()
    torch.cuda.synchronize()
    with count_syncs(torch) as sync_at:
        step(s, imgs[0])
    log(f"host syncs inside one step: {sum(sync_at.values())} {dict(sync_at)}")

    # Throughput: 16 frames per rep, single steps and chunks in turns.
    def run_steps():
        st = make_state()
        for i in range(n_frames):
            st, _ = step(st, imgs[i])

    def run_chunks():
        st = make_state()
        for c in range(N_CHUNKS):
            st, _ = chunk(st, imgs[c * CHUNK:(c + 1) * CHUNK])

    runs = {"single steps": [], "chunks of 8": []}
    run_steps(), run_chunks()
    for _ in range(3):
        for name, fn in (("single steps", run_steps), ("chunks of 8", run_chunks)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
    for name, ts in runs.items():
        med, mn = statistics.median(ts), min(ts)
        log(f"FPS {name}: median {n_frames / med:.2f} (best {n_frames / mn:.2f}) "
            f"= {med / n_frames * 1e3:.3f} ms/frame, 3 reps of {n_frames} frames")

    # Frame 1 through the same step on the CPU (the plain versions).
    cpu_step = pipeline.make_track_step(K, device="cpu", **kw)
    _, cpu_out = cpu_step(make_state(on="cpu"), torch.from_numpy(frames[1]))
    T_cpu = cpu_out.T_w2c.numpy()
    d_R, d_t = np.abs(T_cpu[:3, :3] - T[0, :3, :3]).max(), np.abs(T_cpu[:3, 3] - T[0, :3, 3]).max()
    log(f"frame 1, CUDA step vs CPU step (plain versions): |dR| {d_R:.5f} |dt| {d_t:.4f} m, "
        f"inliers {int(n_inl[0])} vs {int(cpu_out.n_inliers)}")
    if d_R > R_ATOL or d_t > T_ATOL:
        raise AssertionError("CUDA step disagrees with the CPU step on frame 1")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # The batched VO step: MS_B sequences in one step, counted on its own.
    multiseq_launches = run_multiseq(torch, np, dev, render_mod)

    # The pose graphs (whose first solve pays the one-time set-up of
    # torch.func and the solver), then the loop path, counted on its own.
    run_pose_graphs(torch, np, dev)
    loop_launches = run_loop_path(torch, np, step, dev, counters)
    fp_launches, _ = run_full_pipeline(torch, np, dev, counters)
    # The async heavy boundary on the same deployment: measured, then again
    # with the host syncs counted over the whole run.
    for check in (False, True):
        more, _ = run_full_pipeline(torch, np, dev, counters, async_boundary=True, sync_check=check)
        fp_launches = [a + b for a, b in zip(fp_launches, more)]
    run_ba_layouts(torch, np, dev)
    facade_launches = run_facade_phases(torch, np, dev, counters)
    depth = run_depth_facade_phases(torch, np, dev, (LaunchSum(patches_and_moments_levels,
                                                               patches_and_moments_batched), *counters[1:]))
    stereo, rgbd = depth["stereo"], depth["rgbd"]
    stereo_launches = [stereo["k1"], stereo["k2"], stereo["k3"], stereo["k4"], 0]
    lp_launches, lp_k4, lp_k4_args = run_loop_pipeline(torch, np, dev, counters)
    parts = list(zip(launches, loop_launches, fp_launches, facade_launches, stereo_launches, lp_launches))
    for row, part in zip(rows, parts):
        row["launches"] = sum(part)
    for row, n in zip(rows[len(parts):], multiseq_launches):
        row["launches"] = n
    rows[len(parts) + len(multiseq_launches)]["launches"] = stereo["k1_batched"]  # the stereo pairs' K1
    for row, key in zip(rgbd_rows, ("k1", "k2", "k3")):
        row["launches"] = rgbd[key]
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch in the RGB-D phases")
    if rgbd["k1_batched"] or rgbd["k4"]:
        raise AssertionError(f"RGB-D phases launched the batched K1 {rgbd['k1_batched']} and K4 {rgbd['k4']} times")
    log("launches per kernel (tracking, loop path, full pipeline with its two async runs, facade phases, stereo "
        "facade phases, loop pipeline phases with the async and sparse passes): "
        f"{[(r['name'], *part) for r, part in zip(rows, parts)]}; K5 has no caller on any path; "
        f"batched (multiseq phase; stereo phases) and RGB-D phases: "
        f"{[(r['name'], r['launches']) for r in rows[len(parts):]]}")
    # K4 at the ring's own shortlist shapes: the on pass's fullest detect.
    rows.append(k4_row(torch, lp_k4_args, "hamming_top2_batched, loop pipeline shortlist"))
    rows[-1]["launches"] = lp_k4

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
