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
   held at B = 1 to its one-sequence kernel, the batched K1 at the stereo
   facade's B = 2 (its world's first pair), and at the batched stereo
   step's B = 8 (four pairs, after the stereo step phase). K1, K2 and K3 again at
   the RGB-D facade's shapes: K1 on its world's first frame (640x480) at
   1000 features, K2 at 1000 x 1000, K3 on its 2048-slot landmark block,
   and K3 on RGB-D ``CompiledSLAM``'s 4096-slot arena at 1000 keypoints.
4. Tracking path: the fused mono tracking step with a 4096-slot local-map
   arena, 2000 features, 4 levels, 128 RANSAC hypotheses, over a rendered
   376x1240 sprite world (f = 718.856) in two chunks of 8 frames. Checks
   poses against ground truth and the kernels' launch counts, lists the host
   syncs inside one step, times single steps and chunks, and holds one frame
   against the same step run on the CPU through the plain versions.
   Every phase that counts host syncs fails on one from ``ops/linalg.py``,
   ``ops/lie.py``, ``ops/pnp.py`` or ``ops/triangulation.py``
   (``count_syncs``): on CUDA tensors the small solvers take their direct
   methods and closed forms. Then the DLT lowerings (``run_lowerings``):
   RANSAC's 128 minimal samples of 6 points (half all inliers) and an
   LO-style refit over ~400 inliers at bench width, the CUDA route on the
   card against the CPU route (``eigh`` and the SVDs) on the same inputs:
   nullvector alignment, pose differences, each route's ms, and no host
   sync in the CUDA route.
   Then batched VO (``parallel.make_batched_vo``, BASELINE config 5), one
   JSON line per sub-phase: 4 sprite worlds like this one (seeds 0-3)
   tracked 16 frames at once with the local map and without; gates: every
   sequence as above and within R_ATOL / T_ATOL of the single step on it
   over the first chunk, the batched K1/K2/K3 launched (1, 1, 1) / (1, 1,
   0) times a step, at most 1.25x the single step's CUDA kernels
   (torch.profiler) and no more host syncs. Then bench_multiseq's setup at
   2000 and 4000 features: aggregate and single-step FPS, efficiency,
   syncs, peak memory, busy share (recorded, no gate).
   Then the stereo tracking step (``make_track_step(stereo=True)``) on
   bench_stereo_step's world (tests/stereo_step_world.py: 12 pairs at
   376x1240, the KITTI rig's 0.54 m baseline, 2000 features), one JSON line
   per sub-phase (``run_stereo_step``): bench's run (stereo_tracked_fps,
   stereo_kp_z_valid_frac, stereo_n_inliers, the depth funnel, syncs
   against the mono step's, the stereo match's and K1's device ms), with
   the local map, in chunks of 8 and batched over 4 worlds; gated against
   the JAX package's CPU run of the world (SS_JAX) and on launches (a pair
   is one batched K1 launch, B pairs one launch of 2B frames).
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
   Then the stereo pipeline (``run_stereo_pipeline``): bench_stereo_pipeline's
   deployment through stereo ``CompiledSLAM`` (tests/stereo_pipeline_world.py:
   48 pairs of ``bench.synth_kitti_frames(seed=3, baseline=0.54, step=0.6,
   n_sprites=1500)`` at 376x1240, 2000 features, self-promoting chunks of 8
   minting landmarks from the step's depths, a heavy boundary every second
   promotion, f16 upload, a BA of at most 4096 landmarks), uncut, with the
   bench's bootstrap, warm-up and timed window. Prints stereo_pipeline_fps,
   stereo_pipeline_ate_pct_of_path_metric (no scale alignment), keyframes,
   landmarks, the bootstrap pair, LOST pairs, device-minted slots per
   promotion, double mints, BA solves over the landmark cap and the largest
   map, host syncs per chunk (against the mono full pipeline's), K1 / K2 / K3
   launches per pair and peak memory. Fails on a bootstrap on another pair
   than the JAX package's CPU run (SP_JAX), a LOST pair, a metric ATE above
   max(2 x JAX's, SP_ATE_PCT_FLOOR) % of the path, no device-minted slot, or
   launches other than one batched K1 a pair (the one-frame K1 never) and
   the run's steps and matches for K2 and K3. The ATE gate's failure is
   raised after the last phase, so the phases after this one still run.
   Then the RGB-D pipeline (``run_rgbd_pipeline``): TUM1's world
   (tests/rgbd_pipeline_world.py: 32 frames at 640x480 with metric depth
   maps, 1000 features, 4 levels) through RGB-D ``CompiledSLAM``
   (``track([image], t, depth)``: a one-frame bootstrap from the depth map,
   then the mono step) in self-promoting chunks of 8 with keyframe
   interval 2, every frame tracked: the bootstrap, one warm-up chunk (host
   syncs counted there), the rest timed with ``flush()`` inside. Prints the
   FPS, a chunk's ms by boundary stage, syncs a chunk, the metric ATE,
   keyframes, landmarks, heavy boundaries and BA solves, LOST frames, K1 /
   K2 / K3 launches a frame and peak memory, beside the card's name and
   power limit. Fails on a bootstrap on another frame than the JAX
   package's CPU run (RP_JAX), a LOST frame, a frame without a pose, a
   metric ATE above max(2 x JAX's, RP_ATE_PCT_FLOOR) % of the path, no
   heavy boundary with a BA solve, or launches other than the run's
   detects and steps for K1 (one frame; the batched K1 never), its steps
   and matches for K2, and its steps for K3.
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
      frames, a blackout at frames 60-62) with loop closing on, and off over
      its first ENDURANCE_OFF_FRAMES frames:
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
10. Feature families (``run_feature_families``, tests/facade_world.py's
   FAMILIES), one JSON line per part and run:
   a. detectors: Shi-Tomasi ORB, GradHist, Shi-Tomasi GradHist and DoG
      SIFT on frame 0 of the deploy world (376x1240, 2000 features) on the
      card and on the CPU: valid keypoints, the share at the same position
      and octave, angle and descriptor agreement, ms a detect (median of
      FF_DET_REPS synchronised calls), peak memory; fails below FF_TOL's
      parity, or when K1 launches other than once a Shi-Tomasi ORB detect
      (never for a float family);
   b. IVF: tests/test_ann.py's construction at FF_IVF_ROWS rows and
      FF_IVF_QUERIES queries: build and search ms (device and wall); fails
      on a recall against the exact match (K2 over all the rows) below
      FF_IVF_RECALL_MIN, an invalid row matched, or a search that differs
      from its CPU run;
   c. facade: ``SLAM`` with the deploy settings and each family's detector
      and matcher over the deploy world's first FAMILY_FRAMES frames at its
      RANSAC seeds, each run classed as in 8a: FPS after the bootstrap,
      host ms a frame by stage, keyframe ATE, keyframes, landmarks,
      descriptor widths, K1-K4 launches, peak memory. Per family it fails
      on more failed runs than the JAX package's CPU run (FF_JAX), a median
      keyframe ATE of the clean runs above max(2 x JAX's, FF_ATE_PCT_FLOOR),
      a float family with landmark descriptors other than 128 wide or any
      K1-K4 launch, or Shi-Tomasi ORB launches that disagree with its
      detects, matches and guided matches. A family that the JAX package
      fails at every seed there (Shi-Tomasi ORB) runs
      tests/test_float_family_slam.py's world and ``sift_config`` instead,
      each run held to that test's assertions.
11. Adam bundle adjustment (``run_adam``, ``optimization.solver="adam"``),
   one JSON line per part:
   a. ``adam_bundle_adjust`` on bench.py's BA problem (tests/ba_world.py:
      W = 10, M = 4096) with 150 steps: wall per synchronised call, device
      ms, the kernels and busy ms a step under the profiler, host syncs
      inside the solve, cost0 and cost, against its CPU run,
      and the LM's ``bundle_adjust`` (20 iterations) beside it; fails on a
      cost not below half of cost0, a host sync, or a card run off the
      CPU's by more than tests/ba_world.py's ADAM_* tolerances;
   b. ``SLAM`` with ``solver="adam"`` over the deploy world's first
      ADAM_FRAMES frames, counted, classed and printed as the facade runs
      of 8a beside the JAX package's CPU run, then over the e2e sprite
      world (JAX loses the deploy world at rounding-sized changes of its
      images; ADAM_FRAMES' comment); fails unless each run's optimizer is
      the ``AdamOptimizer`` and solved with finite poses, on launches that
      disagree with the run's detects, matches and guided matches, or on
      the e2e run failing tests/test_torch_adam.py's SLAM assertions (OK,
      no LOST frame, 3 keyframes, a keyframe ATE at most max(1.5 x JAX's,
      JAX's + 0.1 m) and below 0.5 m);
   c. K2 and K4 (K4_WIDE_C candidate blocks) at 2000 queries against
      K2_WIDE_ROWS train rows, exact against their plain versions, and
      ``FlannMatcher``'s exact route at FLANN_EXACT_ROWS binary train rows,
      the card exactly as the CPU.
12. Dataset entry point (``run_dataset``, tests/dataset_world.py), one JSON
   line per part: the deploy world's first RD_FRAMES frames written as 8-bit
   PNG files (numpy + zlib) with a KITTI calib.txt; the native loader built
   from native/loader.cpp, ``decode_image`` and ``NativeDatasetSource`` held
   to the written arrays exactly; examples/run_dataset_torch.py through the
   loader on the card (RD_ARGS: 2000 features, 4 levels) and the same uint8
   frames from memory through the same ``Processing`` and config: the same
   states and keyframe centres within RD_POSE_ATOL, no decode error, the
   exports loaded back (TUM and KITTI rows within RD_EXPORT_ATOL of the
   keyframe poses, map.npz onto the card, one PLY vertex per good
   landmark), K1-K3 launched; the deploy run's outcome and keyframe ATE
   classed and printed beside the JAX package's CPU run (RD_JAX), with FPS
   from PNG and from memory after the bootstrap. The ATE and state gates
   read the 320x240 PNG world (SMALL_ARGS): OK, no LOST frame, at least 2
   keyframes, keyframe ATE <= max(2 x JAX's, RD_ATE_PCT_FLOOR) (RD_SMALL_JAX;
   RD_JAX's comment says why). Then examples/visual_odometry_demo_torch.py
   with ``device_trace`` around two of its frames (the trace must name K1,
   K2 and K3: the profiler sees the ctypes launches), and ``flops_of`` /
   ``mfu`` of one LM solve at bench.py's W 10, M 4096 (products only).
13. Loop pipeline (tests/loop_pipeline_world.py): bench_loop_pipeline's
   deployment through ``CompiledSLAM`` on the card, one JSON line per run:
   the 200-frame ring at 376x1240 around 2400 sprites with noise and
   brightness drift, 2000 features, self-promoting chunks of 8, a heavy
   boundary every second promotion; the frames rendered once and shared.
   a. on: loop closing on, bootstrap then two heavy cycles before the
      clock (host syncs per chunk counted there), a checkpoint after frame
      LP_CHECKPOINT (``flush()``, ``save``; off the clock);
   b. off: loop closing off, the same policy, over the first LP_SHORT
      frames;
   c. resume: the id counters reset to 0 as in a new process,
      ``CompiledSLAM.resume(..., device="cuda")`` of the checkpoint, the
      frames after it tracked;
   d. small ring, where the JAX package's on pass closes no loop:
      test_compiled_slam_devpromo_loop_closing's 100-frame 320x240 world,
      with a checkpoint after SR_CHECKPOINT, then a new system resumed from
      it as in c. Each resumed pass whose uninterrupted pass closed after
      its checkpoint must close too, and at least one of the two is held
      to that;
   e. async: loop closing on, async heavy boundaries at their default
      gates; gates: no LOST frame, OK, ATE <= max(2 x JAX's CPU figure,
      LP_ATE_PCT_FLOOR), K4 launched, an async boundary ran, every async
      solve on the side stream;
   f. sparse: loop closing on, ``sparse_obs="auto"``, over the first
      LP_SHORT frames, then one more global BA over the final map, timed;
      gates as e., and every solve from the
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
14. Prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``
   as the last line. Any failure raises and exits nonzero.

K5 has no caller in either package: only phase 3 launches it. The
kernels' launch counts add up the tracking, stereo step, loop,
full-pipeline, stereo pipeline, facade, stereo facade, feature-family (its
detectors and facade runs), adam (its facade run), dataset (its runs and the
demo) and loop pipeline phases; the batched rows' count the batched VO phase's batched steps, the
B = 2 row's the stereo facade phases', the stereo step's and the stereo
pipeline's pairs, the B = 8 row's the batched
stereo step's, the RGB-D rows' the RGB-D facade phases' and the RGB-D
pipeline's launches (K1 and K2 both; the 2048-slot K3 the facade's, the
4096-slot K3 the pipeline's; each at least one), and the loop pipeline's
K4 row the K4 launches of its runs. The stereo step phases count their
first timed repeat and the local-map run.
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
# A plain version's device time: it takes 0.3-56 ms a call and leaves host gaps (so device_ms runs its loop
# twice), and 20 calls average it as well as 200; the 200 took about 45 s of the script's 1200 s limit, 50
# about 15 s (20 now, to make room for the adam phase; no gate reads it).
PLAIN_DEVICE_REPS = 20
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
# package relocalizes. A synchronous run on the card repeats bit for bit
# from one call to the next, so a seed is one fixed draw; to keep the
# script inside its time limit it runs the default seed and seeds 0 and 1,
# at which the JAX package fails none.
# Each seeded run here is classed and printed; the gates read the count of
# failed runs and the medians of the ATEs and keyframe counts, the ATE
# gates still at twice the medians of JAX's nine runs. Endurance, loop
# closing on and off alike: final state OK, 3 LOST frames (the blackout), 1
# relocalization, 0 closures, 96 keyframes, keyframe ATE 5.198 %. Gates:
# failed runs at most JAX's at these seeds, median ATE at most max(2 x
# JAX's median, 2.0 %), median keyframes within 30 % of 23, closures at
# least JAX's, ATE on below off only where JAX's was. As JAX's on pass is
# not below its off pass, the off pass stops after ENDURANCE_OFF_FRAMES
# (the blackout and the relocalization inside them; the whole ring takes
# about 30 s beside an NVIDIA H100 80GB HBM3 at 700 W) and is held to its
# own gates.
FACADE_FRAMES, FACADE_SYNC, PROCESSING_FRAMES = 64, 8, 16
FACADE_SEEDS = (0, 1)
FACADE_KF_ATE_PCT_MAX, FACADE_FRAME_ATE_PCT_MAX = 2.0, 3.142
FACADE_KF_RANGE = (17, 29)
FACADE_JUMP_PCT, FACADE_JAX_FAILED_RUNS = 5.0, 0  # JAX's failed runs at 13, 0 and 1
ENDURANCE_JAX_CLOSURES, ENDURANCE_JAX_ON_BELOW_OFF, ENDURANCE_OFF_FRAMES = 0, False, 100
# Threaded facade (the deployment world, SLAM(threaded=True)): the JAX
# package's 8 CPU runs (scripts/depth_facade_reference.py --world
# deploy-threaded --reps 8) failed 3: two ended LOST (29 and 12 LOST frames,
# keyframe ATE 5.746 and 0.786 %), one relocalized after 2 LOST frames
# (0.241 %); the five clean runs ended at 0.152-0.897 %. A run here fails
# as those did, or above twice FACADE_KF_ATE_PCT_MAX; of THREADED_RUNS runs
# at most ceil(2 x 3/8) = 1 may.
THREADED_RUNS, THREADED_JAX_FAILED, THREADED_JAX_RUNS = 2, 3, 8
THREADED_FAILED_MAX = -(-THREADED_RUNS * THREADED_JAX_FAILED // THREADED_JAX_RUNS)
# Stereo and RGB-D facade (tests/depth_world.py), at the tracker's default
# RANSAC seed (13) and DEPTH_SEEDS, then the fused step at the default seed.
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
# clean. A synchronous run on the card repeats bit for bit, so to keep the
# script inside its time limit the seeded runs are the default seed and
# seed 0 (JAX fails 0 and 2 of them), the median gate at twice JAX's median
# of the five runs above.
DEPTH_SEEDS = (0,)
STEREO_FRAMES, RGBD_FRAMES, DEPTH_PROCESSING_FRAMES = 48, 32, 16
DEPTH_JAX = {"stereo": {"failed": 0, "median_pct": 0.788, "fused_clean": True, "kp_z_valid_frac": 0.3058},
             "rgbd": {"failed": 2, "median_pct": 1.236, "fused_clean": False, "kp_z_valid_frac": 0.9264}}
DEPTH_PORT_CPU_FAILED = {"stereo": 0, "rgbd": 0}
# Feature families (tests/facade_world.py's FAMILIES): the detectors on frame
# 0 of the deploy world against the same detectors on the CPU, the IVF index,
# and the host facade over the deploy world's first FAMILY_FRAMES frames per
# family at its RANSAC seeds. FF_JAX is the JAX package's CPU run of those
# facade runs (scripts/float_family_reference.py --impl jax): per family its
# failed runs (LOST after the bootstrap, or a keyframe ATE above
# FACADE_JUMP_PCT) and the median keyframe ATE (% of the path) of the clean
# ones. DoG SIFT + L2 at seeds 13, 0, 1, 2: all clean, 2.110-2.383 % (11-12
# keyframes, 651-885 landmarks); GradHist + L2 at 13, 0: both clean, 0.533
# and 0.462 % (at seeds 1-5 one of five LOST); Shi-Tomasi ORB + Hamming at
# 13, 0: both LOST (frames 19 and 25, keyframe ATE 20.5 and 19.2 %), so that
# family runs tests/test_float_family_slam.py's world and sift_config instead
# (JAX there: both seeds end OK with 7 keyframes and 258-288 landmarks, the
# test's assertions; keyframe ATE 10.7 and 9.3 %, which the test does not
# assert). Gates, fixed before the first run on the card: failed runs at most
# JAX's, that median at most max(2 x JAX's, FF_ATE_PCT_FLOOR); on the e2e
# world, every run passes the test's assertions; a float family keeps
# 128-word landmark descriptors and launches none of K1-K4; Shi-Tomasi ORB
# launches K1, K2 and K3 once per detect, brute match and guided match.
FF_JAX = {"sift": {"failed": 0, "median_pct": 2.2971},
          "gradhist": {"failed": 0, "median_pct": 0.4973},
          "shi_tomasi_orb": {"failed": 2, "median_pct": None}}
FF_ATE_PCT_FLOOR = 2.0
FF_DET_REPS = 20  # synchronised detects a detector is timed over
# Detector parity, card against CPU, on the shared keypoints (at least
# FF_SHARE_MIN of the CPU's valid ones at the same position and octave): at
# least FF_SHARE_MIN of them with the angle and the descriptor within the
# family's tolerance (tests/test_torch_float_ops.py, tests/test_torch_sift.py),
# the Shi-Tomasi ORB descriptors on at least FF_BIT_SHARE_MIN of the bits.
FF_SHARE_MIN, FF_BIT_SHARE_MIN = 0.98, 0.99
FF_TOL = {"shi_tomasi_orb": {"xy": 1e-3, "angle": 1e-4},
          "gradhist": {"xy": 1e-3, "angle": 1e-4, "desc": 1e-4},
          "shi_tomasi_gradhist": {"xy": 1e-3, "angle": 1e-4, "desc": 1e-4},
          "sift": {"xy": 2e-3, "angle": 1e-2, "desc": 5e-3}}
# IVF: tests/test_ann.py's construction at FlannMatcher's scale: random
# 256-bit rows from seed 0 (the last 32 invalid), perturbed copies of valid
# rows as queries, FlannMatcher's cluster count for the rows, 8 probes.
FF_IVF_ROWS, FF_IVF_QUERIES, FF_IVF_CLUSTERS, FF_IVF_PROBES, FF_IVF_RECALL_MIN = 16384, 2000, 128, 8, 0.9
# The Adam bundle adjustment (optimization.solver="adam", backend/adam.py):
# (a) adam_bundle_adjust alone on bench.py's BA problem (tests/ba_world.py's
# bench_problem: W = 10, M = 4096, 5 px Huber at f = 718.856) with
# ADAM_ITERS steps at ADAM_LR, beside the LM's bundle_adjust with
# ADAM_LM_ITERS iterations on the same problem; gates: the cost below half
# of cost0, no host sync inside the solve, and T, X and the cost curve of
# the card within tests/ba_world.py's ADAM_* tolerances of the CPU run.
# A solve is host-bound (1173 ms wall a synchronised solve on an NVIDIA H100
# 80GB HBM3 at 700 W):
# wall over ADAM_REPS calls after the first (which counts the host syncs),
# device ms by events over one call (with the host's gaps: an upper bound),
# and the device's busy ms and kernels per step under torch.profiler over an
# ADAM_PROFILE_ITERS-step solve (profiling all 150 steps, about 40k kernels,
# took about 15 s of the phase on that card). The LM's solve is profiled
# whole.
ADAM_ITERS, ADAM_LR, ADAM_LM_ITERS, ADAM_REPS, ADAM_PROFILE_ITERS = 150, 1e-3, 20, 2, 10
# (b) SLAM with solver="adam" over the deploy world's first ADAM_FRAMES
# frames (376x1240, 2000 features) at the tracker's default RANSAC seed. The
# JAX package's CPU runs (scripts/facade_reference.py --impl jax --world deploy
# --frames 32 --solver adam [--perturb ...]): at
# seed 13 OK, 14 keyframes, keyframe ATE 0.714 % (seeds 0-7: clean,
# 0.566-1.040 %), but on the images scaled by 1 +- 1e-6, 1 +- 2e-6 and 1 +
# 3e-6 (rounding-sized changes) at seeds 13, 0 and 1 it goes LOST in 6 of
# the 15 runs (clean ones 1.15-2.90 %); the port's CPU runs of the same 15
# lose 1 and jump scale in 2 (clean 0.45-3.60 %). One run of this world is
# a draw in either package, so, as for a feature family JAX loses (phase 10),
# the ATE gate reads the sprite world of
# tests/test_torch_adam.py's SLAM test (tests/facade_world.py's e2e world,
# 12 frames at 320x240), where JAX's run at seed 13 ends OK with no LOST
# frame, 9 keyframes and a keyframe ATE of ADAM_E2E_JAX_ATE_M (seeds 0-3:
# 0.111-0.158 m), with that test's assertions: OK, no LOST frame after the
# bootstrap, at least 3 keyframes, the ATE at most max(1.5 x JAX's, JAX's +
# 0.1 m) and below 0.5 m. The deploy run is classed and printed beside
# JAX's; its gates: the AdamOptimizer built and solving, finite poses, the
# launches the run's calls made.
ADAM_FRAMES = 32
ADAM_JAX_DEPLOY_ATE_PCT = 0.7142382081237795
ADAM_E2E_FRAMES, ADAM_E2E_JAX_ATE_M = 12, 0.23079223256077538
# The dataset phase (run_dataset): the deploy world's first RD_FRAMES frames as
# PNG files through examples/run_dataset_torch.py with RD_ARGS, and the 320x240
# render_sequence world of tests/dataset_world.py (SMALL_ARGS). RD_JAX /
# RD_SMALL_JAX: the JAX package's examples/run_dataset.py on the CPU over the
# same files with the same flags and --cpu (each OK, no LOST frame), keyframe
# ATE in % of the path (scripts/run_dataset_reference.py). JAX loses the deploy
# files at rounding-sized changes (scripts/facade_reference.py --world dataset,
# RANSAC seeds 13, 0-3, images scaled by 1 and 1 +- 1e-6: 2 LOST and 2 scale
# jumps in 15 runs, and 4 of the 11 clean runs above 2 %), so the ATE and state
# gates read the small world, as the feature-family and adam phases do for
# worlds JAX loses; the deploy run is classed and printed beside JAX's.
RD_FRAMES = 32
RD_ARGS = ["--native-loader", "--levels", "4", "--frames", str(RD_FRAMES)]
RD_JAX = {"ate_pct": 0.8382562790297425, "keyframes": 13, "map_points": 1164}
RD_SMALL_JAX = {"ate_pct": 1.7530640437257685, "keyframes": 7, "map_points": 463}
RD_ATE_PCT_FLOOR = 2.0
RD_POSE_ATOL = 1e-5  # m, native against in-memory keyframe centres (expected identical)
RD_EXPORT_ATOL = 1e-5  # the TUM and KITTI rows against the keyframe poses
RD_TRACE_AFTER = 9  # the demo's frames traced start after this one: two, or until K1-K3 have each launched
RD_KERNEL_NAMES = {"K1": "patches_moments_kernel", "K2": "hamming_tile_kernel", "K3": "guided_top2_kernel"}
# (c) K2 and K4 past the 5800 train rows the 32-bit row partial held them
# to: K2 at 2000 queries against each of K2_WIDE_ROWS train rows, K4 with
# K4_WIDE_C candidate blocks of those rows, both exact against their plain
# versions; FlannMatcher's exact route (below its ann_threshold of 8192) at
# FLANN_EXACT_ROWS binary train rows, the card against the CPU exactly.
K2_WIDE_ROWS, K4_WIDE_C, FLANN_EXACT_ROWS = (5801, 8192, 16384), 8, (6000, 8191)
# Host ms a frame in detect of the mono facade's deploy run at seed 13 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 5), printed beside the
# stereo and RGB-D runs' own.
MONO_FACADE_DETECT_MS = 41.51
DEPTH_SCALE_RANGE = (0.8, 1.25)
PAIR_BIT_SHARE_MIN = 0.999  # a stereo pair's batched descriptors against two single detects
# Batched VO (parallel.make_batched_vo, BASELINE config 5): bench_multiseq's
# 4 sequences, its 30 timed steps after one warm-up over 4 distinct batches,
# at bench.py's 2000 features and config 5's 4000; 1 throughput repeat (no
# gate reads it). Steps under torch.profiler: MS_PROFILE_STEPS a call, as
# reading back a profile costs seconds per step of ~5300 kernels.
MS_B, MS_STEPS, MS_BATCHES, MS_REPS = 4, 30, 4, 1
MS_FEATURES = (2000, 4000)
MS_PROFILE_STEPS = 2
MS_KERNEL_RATIO_MAX = 1.25  # CUDA kernels of a batched step over a single step's
STEP_SPANS = ("detect", "stereo_match", "match", "guided_match", "ransac_pnp", "fallback_gn")
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
# <= max(2 x the on pass's, LP_ATE_PCT_FLOOR). To keep the script inside
# its time limit, the off pass and the sparse pass stop after LP_SHORT
# frames of the ring (a whole pass takes about 35 s beside an NVIDIA H100
# 80GB HBM3 at 700 W):
# the off pass's K4 gate reads the detects loop closing would make from
# frame 56 on, the sparse pass's the solves of its first 120 frames, and
# their ATE (of their own stretch of the path) stays under the
# LP_ATE_PCT_FLOOR that their gates' floors set.
LP_JAX = {"on_closures": 0, "on_ate_pct": 0.2828, "off_ate_pct": 0.3323, "async_ate_pct": 0.1946,
          "sparse_ate_pct": 0.3264}
LP_CHECKPOINT, LP_DT, LP_ATE_PCT_FLOOR, LP_SHORT = 103, 0.1, 2.0, 120
# The small ring's checkpoint: a chunk end (bootstrap on frame 4, chunks of
# 4) before its closure at frame 95 on the card, which its resumed pass must
# make too (no LOST frame, OK at the end, the saved counts restored).
SR_CHECKPOINT = 72
# Stereo tracking step: bench_stereo_step's world and run
# (tests/stereo_step_world.py). The JAX package's CPU run of it
# (scripts/stereo_step_reference.py --impl jax): on pair 0, 709 of the 2000
# slots depth-valid (stereo_kp_z_valid_frac 0.3545); at pair 1, 372
# inliers and the translation below, 0.0368 m off ground truth. Gates: the
# fraction within SS_FRAC_ATOL of JAX's, pair 1's inliers at least
# SS_INLIER_SHARE of JAX's and its translation within SS_T_ATOL (the bound
# of tests/test_torch_pipeline.py) of JAX's and of ground truth; a chunk's
# poses equal the single steps' within SS_CHUNK_ATOL; the batched step at
# B = 1 equals the single step in every output, the pose within
# SS_B1_POSE_ATOL (its batched small products round otherwise).
SS_JAX = {"kp_z_valid_frac": 0.3545, "n_inliers": 372,
          "pair1_t": [-0.5367594957351685, 0.0008527803001925349, -0.0016069788252934813]}
SS_FRAC_ATOL, SS_INLIER_SHARE, SS_T_ATOL, SS_CHUNK_ATOL, SS_B1_POSE_ATOL = 0.02, 0.9, 0.06, 1e-5, 1e-5
# bench's 60 timed steps, 1 repeat (bench's 3; no gate reads the FPS, and
# the script must fit its time limit); chunks of 8; 4 sequences. To keep the phases under
# 90 s on a slow host, the local-map run and each chunk repeat take SS_SHORT
# steps, and each batched repeat bench_multiseq's MS_STEPS.
SS_STEPS, SS_REPS, SS_CHUNK, SS_B, SS_SHORT = 60, 1, 8, 4, 16
# Stereo pipeline: bench_stereo_pipeline's world, deployment and run
# (tests/stereo_pipeline_world.py). The JAX package's CPU run of it
# (scripts/stereo_pipeline_reference.py --impl jax): bootstrap on pair 0,
# no LOST pair, metric ATE (no scale alignment) 0.2006 m = 0.836 % of the
# 24.0 m path, 11 keyframes, 6399 landmarks, 10 device promotions minting
# 553-649 slots each, no double mint, 2 BA solves over the 4096-landmark cap
# (5197 and 6399 landmarks handed in). Gates: the bootstrap on JAX's pair, no
# LOST pair, ATE at most max(2 x JAX's, SP_ATE_PCT_FLOOR) % of the path, at
# least one device-minted slot, K1 once a pair (the batched launch; the
# one-frame K1 never), K2 and K3 as the run's steps and matches. The port
# gives the bootstrap's landmarks descriptors, where JAX leaves them without
# (ROADMAP F6): JAX's own runs of this world scaled by 1 + eps, eps a few
# 1e-6, end at 1.1-2.0 %, one of three reseeded ones LOST.
SP_JAX = {"bootstrap_frame": 0, "ate_pct": 0.8357}
SP_ATE_PCT_FLOOR = 2.0
# RGB-D pipeline: TUM1's world through RGB-D CompiledSLAM
# (tests/rgbd_pipeline_world.py: 32 frames at 640x480, 1000 features,
# self-promoting chunks of 8, keyframe interval 2). The JAX package's CPU run
# of it (scripts/rgbd_pipeline_reference.py --impl jax): bootstrap on frame 0
# (952 landmarks), no LOST frame, metric ATE 0.2259 m = 2.391 % of the 9.45
# m path, 14 keyframes, 1745 landmarks, 13 device promotions, 4 heavy
# boundaries and 4 BA solves. Over RANSAC seeds 1-7 it ends at 1.752-3.130 %
# (seed 6 LOST at the flush), with the images scaled by 1 + eps (eps +-1e-6,
# 2e-6, 3e-6) at 0.698-2.775 %; at keyframe interval 4 it keeps its one
# keyframe and goes LOST at the first chunk boundary. Gates: the bootstrap on
# JAX's frame, no LOST frame, OK at the end, a pose for every frame, ATE at
# most max(2 x JAX's, RP_ATE_PCT_FLOOR) % of the path, at least one heavy
# boundary with a BA solve, K1 (one frame) and K2 as the run's detects, steps
# and matches, K3 once a step.
RP_JAX = {"bootstrap_frame": 0, "ate_pct": 2.3913}
RP_ATE_PCT_FLOOR = 2.0
MONO_FP_SYNCS_PER_CHUNK = 66  # the mono full pipeline's before the small solvers' CUDA route, PERF.md section 5
# Source files whose host syncs fail a phase: on CUDA tensors nullspace_vector,
# the DLT's pose and the triangulation read nothing back to the host.
SYNC_FREE_FILES = ("ops/linalg.py", "ops/lie.py", "ops/pnp.py", "ops/triangulation.py")
# The DLT lowerings: a bench-width frame's 3D-2D pairs (valid pairs, of which
# inliers, at 0.5 px noise) and RANSAC's minimal samples.
LW_PAIRS, LW_INLIERS, LW_HYP, LW_NOISE_PX = 1000, 400, N_HYP, 0.5
LW_REFIT_ALIGN_MIN = 1 - 1e-4  # |<v_cuda, v_cpu>| of the refit's nullvector
LW_REFIT_R_ATOL, LW_REFIT_T_ATOL = 1e-3, 1e-2  # the refit's pose, CUDA route against the CPU route


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
    """One row of the kernels JSON: device time (``device_ms``, events, over
    DEVICE_REPS calls of the kernel and PLAIN_DEVICE_REPS of the plain
    version) and host+device wall (``ms``, as in the rows of earlier
    versions) of the kernel, of its plain version and, where one PyTorch call computes the
    same function, the device time of that call; the bound and the share of
    it reached. ``work`` is ``bound()``'s dict for this call's inputs."""
    dev, gapless = device_ms(fn)
    plain_dev, plain_gapless = device_ms(plain, n=PLAIN_DEVICE_REPS)
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
    of the sync's call stack. Raises at the block's end if a sync came from
    one of SYNC_FREE_FILES."""
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
    bad = {k: n for k, n in sync_at.items() if any(f in k for f in SYNC_FREE_FILES)}
    if bad:
        raise AssertionError(f"host syncs from {SYNC_FREE_FILES}: {bad}")


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


def batched_k1_args(torch, np, frames):
    """The batched K1's arguments for ``frames`` (B frames, stacked as the
    batched detect stacks them): (levels, blurred levels, keypoints per
    level, moment weights) on the card."""
    from visual_slam_tpu_torch.ops import orb, pyramid
    from visual_slam_tpu_torch.ops.detector import detect_level, level_quotas

    dev = torch.device("cuda")
    imgs = torch.from_numpy(np.stack(frames)).to(dev)
    w = torch.from_numpy(orb.MOMENT_W_NP).to(dev)
    levels = [lvl.contiguous() for lvl in pyramid.build_pyramid(imgs, N_LEVELS, 1.2)]
    yxs = [detect_level(lvl, k, 20.0, GRID, 16)[0] for lvl, k in zip(levels, level_quotas(N_FEATURES, N_LEVELS, 1.2))]
    return levels, [pyramid.gaussian_blur(lvl) for lvl in levels], yxs, w


def batched_k1_row(torch, np, frames, name="patches_and_moments_batched"):
    """The batched K1 on the four levels of ``frames`` (B frames, stacked as
    the batched detect stacks them: one launch for all frames and levels)
    against its plain version, at B = 1 against the one-frame kernel, then
    timed: its row of the kernels JSON."""
    from visual_slam_tpu_torch.ops import orb
    from visual_slam_tpu_torch.ops.patch_kernels import (
        patches_and_moments_batched,
        patches_and_moments_batched_ref,
        patches_and_moments_levels,
    )

    Bn = len(frames)
    args = batched_k1_args(torch, np, frames)
    levels, _, yxs, w = args
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
    (``Tracking._local_landmark_block``: max(2048, 2 x the budget) slots),
    and K3 on RGB-D ``CompiledSLAM``'s ARENA-slot landmark arena. Returns
    their rows of the kernels JSON."""
    h, w = frame.shape
    n, arena = n_features, max(2048, 2 * n_features)
    rng = np.random.default_rng(2)
    return [k1_levels_row(torch, np, frame, n, f"patches_and_moments_levels, RGB-D {w}x{h}"),
            k2_row(torch, np, rng, n, f"hamming_top2, RGB-D {n} x {n}"),
            k3_row(torch, np, rng, arena, n, f"guided_top2, RGB-D {arena} x {n}", size=(w, h)),
            k3_row(torch, np, rng, ARENA, n, f"guided_top2, RGB-D pipeline {ARENA} x {n}", size=(w, h))]


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


def run_lowerings(torch, np, dev, K) -> dict:
    """The DLT's small solvers on the card against the CPU: one bench-width
    frame's 3D-2D pairs (LW_PAIRS valid pairs at 5-60 m, LW_INLIERS of them
    true at LW_NOISE_PX, the rest uniform over the image), RANSAC's LW_HYP
    minimal samples of 6 pairs (half from the inliers, half from every
    pair) and an LO-style refit (``pnp_dlt`` weighted by the inliers).
    ``pnp_dlt`` on CUDA tensors takes the CUDA route
    (``smallest_eigvec_psd``, ``det3x3``, ``project_to_so3_newton``), on CPU
    tensors the CPU route (``eigh``, the SVDs). Prints the nullvector
    alignment |<v_cuda, v_cpu>| of the same Gram matrices (all-inlier
    samples, mixed ones, the refit), the pose differences, and each route's
    ms: the CUDA route's device and wall ms, the SVD route's on the card
    (``eigh`` and the SVDs on CUDA tensors, as before) and the CPU route's
    wall ms. Fails on a non-finite or improper rotation, a host sync in the
    CUDA route, or a refit off the CPU route's beyond
    LW_REFIT_ALIGN_MIN / LW_REFIT_R_ATOL / LW_REFIT_T_ATOL."""
    from visual_slam_tpu_torch.ops import lie, linalg, pnp

    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    f = float(K[0, 0])
    R = lie.so3_exp(torch.tensor([0.01, -0.02, 0.005])).numpy()
    t = np.array([0.1, -0.05, 0.6], np.float32)
    X = np.stack([rng.uniform(-20, 20, LW_PAIRS), rng.uniform(-3, 3, LW_PAIRS), rng.uniform(5, 60, LW_PAIRS)], 1)
    pc = X @ R.T + t
    xy = pc[:, :2] / pc[:, 2:3] + rng.normal(0, LW_NOISE_PX / f, (LW_PAIRS, 2))
    out = np.arange(LW_PAIRS) >= LW_INLIERS
    xy[out] = np.stack([rng.uniform(-W / 2, W / 2, out.sum()), rng.uniform(-H / 2, H / 2, out.sum())], 1) / f
    X, xy = X.astype(np.float32), xy.astype(np.float32)
    # Half the samples from the inliers (those that win RANSAC's argmin), half from every pair.
    idx = np.stack([rng.choice(LW_INLIERS if h % 2 else LW_PAIRS, 6, replace=False) for h in range(LW_HYP)])
    clean = (idx < LW_INLIERS).all(1)
    w_fit = (~out).astype(np.float32)
    problems = {"minimal": (X[idx], xy[idx], np.ones(idx.shape, np.float32)), "refit": (X, xy, w_fit)}
    report = {"clean_samples": int(clean.sum())}
    for name, (Xp, xyp, wp) in problems.items():
        cpu = [torch.from_numpy(a) for a in (Xp, xyp, wp)]
        gpu = [a.to(dev) for a in cpu]
        R_c, t_c = pnp.pnp_dlt(*cpu)
        with count_syncs(torch) as syncs:
            R_g, t_g = pnp.pnp_dlt(*gpu)
            torch.cuda.synchronize()
        R_g, t_g = R_g.cpu().numpy(), t_g.cpu().numpy()
        R_c, t_c = R_c.numpy(), t_c.numpy()
        # The same Gram matrix through both nullspace routes.
        gram = pnp._dlt_gram(*cpu)
        v_c = linalg.nullspace_vector(gram).numpy()
        v_g = linalg.nullspace_vector(gram.to(dev)).cpu().numpy()
        align = np.abs(np.sum(v_c * v_g, axis=-1)).reshape(-1)
        dR = np.abs(R_g - R_c).reshape(-1, 9).max(1)
        dt = np.abs(t_g - t_c).reshape(-1, 3).max(1)
        det = np.linalg.det(R_g.reshape(-1, 3, 3))
        ortho = np.abs(np.einsum("nji,njk->nik", R_g.reshape(-1, 3, 3), R_g.reshape(-1, 3, 3)) - np.eye(3)).max()
        cuda_fn = lambda: pnp.pnp_dlt(*gpu)  # noqa: E731
        svd_fn = lambda: pnp._dlt_pose_svd(*pnp_dlt_parts(torch, pnp, *gpu))  # noqa: E731
        dms, gapless = device_ms(cuda_fn)
        wall, _ = timed(cuda_fn)
        svd_dms, _ = device_ms(svd_fn, n=20)
        svd_wall, _ = timed(svd_fn)
        t0 = time.perf_counter()
        for _ in range(5):
            pnp.pnp_dlt(*cpu)
        cpu_ms = (time.perf_counter() - t0) / 5 * 1e3
        sel = {"minimal": {"clean": clean, "mixed": ~clean}, "refit": {"all": np.ones(1, bool)}}[name]
        stats = {k: dict(align_min=float(align[m].min()), align_median=float(np.median(align[m])),
                         R_diff_median=float(np.median(dR[m])), R_diff_max=float(dR[m].max()),
                         t_diff_median=float(np.median(dt[m])), t_diff_max=float(dt[m].max()))
                 for k, m in sel.items() if m.any()}
        report[name] = dict(stats, cuda_device_ms=dms, cuda_gapless=gapless, cuda_wall_ms=wall,
                            svd_on_card_device_ms=svd_dms, svd_on_card_wall_ms=svd_wall, cpu_route_ms=cpu_ms,
                            cuda_syncs=sum(syncs.values()), det_min=float(det.min()), ortho_err=float(ortho))
        log(f"DLT lowerings, {name} ({Xp.shape[:-1]}): {json.dumps(report[name])}")
        if not (np.isfinite(R_g).all() and np.isfinite(t_g).all()) or det.min() < 0.99 or ortho > 1e-3:
            raise AssertionError(f"DLT lowerings, {name}: a non-finite or improper rotation (det {det.min()}, "
                                 f"|R^T R - I| {ortho})")
        if syncs:
            raise AssertionError(f"DLT lowerings, {name}: host syncs in the CUDA route {dict(syncs)}")
    ref = report["refit"]["all"]
    if ref["align_min"] < LW_REFIT_ALIGN_MIN or ref["R_diff_max"] > LW_REFIT_R_ATOL or \
            ref["t_diff_max"] > LW_REFIT_T_ATOL:
        raise AssertionError(f"DLT lowerings: the refit's CUDA route is off the CPU route's: {ref}")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"DLT lowerings: {report['clean_samples']} of {LW_HYP} samples all inliers; phase "
        f"{report['phase_s']:.1f} s")
    return report


def pnp_dlt_parts(torch, pnp, X, xy, w):
    """``pnp_dlt``'s SVD route on any device (the CUDA tensors' route before
    the closed forms): ``eigh``'s nullvector, split into ``_dlt_pose_svd``'s
    (M, p4, points, weights)."""
    _, vecs = torch.linalg.eigh(pnp._dlt_gram(X, xy, w))
    P = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    return P[..., :, :3], P[..., :, 3], X, w


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
       the same sequence with the same seed over the same first chunk,
       which is as far as the single step runs (after it, each trajectory
       drifts from ground truth on its own; the batched one's drift is
       printed); each batched step launches the
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
        T_s = []  # the single step over the first chunk, the window of the gates below
        for b, make in enumerate(makers):
            ss, Ts_b = make(seed=b), []
            for i in range(CHUNK):
                ss, o = step(ss, imgs[i, b])
                ss = refresh(ss, o.features, i, b)
                Ts_b.append(o.T_w2c)
            T_s.append(torch.stack(Ts_b).cpu().numpy())
        T_s = np.stack(T_s)
        gt = np.stack([w[1][1:] for w in worlds])
        err_R = np.abs(T_b[:, :CHUNK, :3, :3] - gt[:, :CHUNK, :3, :3]).max(axis=(1, 2, 3))
        err_t = np.abs(T_b[:, :CHUNK, :3, 3] - gt[:, :CHUNK, :3, 3]).max(axis=(1, 2))
        # Against the single step on the first chunk, the tracking gates'
        # window; after it each trajectory drifts from ground truth on its
        # own (the batched step's drift over all 16 frames is recorded).
        d_R = np.abs(T_b[:, :CHUNK, :3, :3] - T_s[:, :, :3, :3]).max(axis=(1, 2, 3))
        d_t = np.abs(T_b[:, :CHUNK, :3, 3] - T_s[:, :, :3, 3]).max(axis=(1, 2))
        gt_t_all = np.abs(T_b[..., :3, 3] - gt[..., :3, 3]).max(axis=(1, 2)).tolist()

        # Kernels per step and host syncs, batched against single (sequence 0).
        costs = step_costs(torch, {"batched": cycling(bstep, stacked(), imgs),
                                   "single": cycling(step, makers[0](seed=0), imgs[:, 0])}, MS_PROFILE_STEPS)
        prof_b, prof_s = costs["batched"], costs["single"]
        n_sync_b, n_sync_s = sum(prof_b["syncs"].values()), sum(prof_s["syncs"].values())
        ratio = prof_b["kernels_per_call"] / prof_s["kernels_per_call"]
        rep = dict(phase="multiseq_track", local_map=local_map, B=MS_B, frames=n_frames,
                   min_inliers=n_inl.min(axis=1).tolist(), min_guided=n_guided.min(axis=1).tolist(),
                   first_chunk_err_R=err_R.tolist(), first_chunk_err_t=err_t.tolist(),
                   vs_single_dR=d_R.tolist(), vs_single_dt=d_t.tolist(), err_t_all_frames_batched=gt_t_all,
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
                                   "single": cycling(step, state(0), singles)}, MS_PROFILE_STEPS)
        agg, one = statistics.median(fps["batched"]), statistics.median(fps["single"])
        rep = dict(phase="multiseq_throughput", features=nf, B=MS_B, steps=MS_STEPS,
                   agg_fps_median=agg, agg_fps_min=min(fps["batched"]), single_fps_median=one,
                   single_fps_min=min(fps["single"]), efficiency=agg / (MS_B * one),
                   agg_fps_reps=fps["batched"], single_fps_reps=fps["single"], peak_mib=peak, profiled=costs)
        log(json.dumps(rep))
    return total


def stereo_states(torch, np, step, pairs, K, dev, seed=0, local_map=False):
    """bench_stereo_step's start on one world: frame 0's features (a single
    detect of the left image), the step on pair 0 from a state around them,
    its depths backprojected into frame 0's landmarks (20 m where a slot has
    none). Returns (make_state(seed), out0, feats0); ``make_state`` gives
    the state around those landmarks, with a 4096-slot arena holding them
    when ``local_map``."""
    import stereo_step_world as ssw

    from visual_slam_tpu_torch import pipeline

    feats0 = step.detect(pairs[0, 0])
    st0 = pipeline.init_track_state(feats0, np.zeros((N_FEATURES, 3), np.float32), feats0.valid, np.eye(4),
                                    seed=seed, device=dev, local_map_size=ARENA if local_map else 0)
    _, out0 = step(st0, pairs[0])
    z_ok = (out0.kp_z_valid & out0.features.valid).cpu().numpy()
    lm, has = ssw.landmarks_from_depths(K, out0.features.xy.cpu().numpy(), out0.kp_z.cpu().numpy(), z_ok)
    if local_map:
        lm_pos = np.zeros((ARENA, 3), np.float32)
        lm_desc = np.zeros((ARENA, 8), np.int32)
        lm_valid = np.zeros(ARENA, bool)
        lm_pos[:N_FEATURES], lm_desc[:N_FEATURES], lm_valid[:N_FEATURES] = lm, feats0.desc.cpu().numpy(), has

    def make(seed: int = seed):
        if not local_map:
            return pipeline.init_track_state(feats0, lm, has, np.eye(4), seed=seed, device=dev)
        s = pipeline.init_track_state(feats0, lm, has, np.eye(4), seed=seed, device=dev, local_map_size=ARENA)
        return pipeline.set_local_map(s, lm_pos, lm_desc, lm_valid)

    return make, out0, feats0


def stepped_fps(step, make_state, frames, n_steps: int, n_seq: int = 1) -> float:
    """bench_stereo_step's timing: ``n_steps`` steps cycled over ``frames``
    from a new state, then one value fetch; frames per second over
    ``n_seq`` sequences."""
    s = make_state()
    t0 = time.perf_counter()
    for i in range(n_steps):
        s, out = step(s, frames[i % len(frames)])
    float(out.T_w2c.flatten()[0])
    return n_seq * n_steps / (time.perf_counter() - t0)


def run_stereo_step(torch, np, dev) -> dict:
    """The stereo tracking step (``make_track_step(stereo=True)``) on
    bench_stereo_step's world (tests/stereo_step_world.py), one JSON line
    per sub-phase:
    1. ``stereo_step``: bench's run. The step on pair 0 gives
       stereo_kp_z_valid_frac and frame 0's landmarks; the step on pair 1
       gives stereo_n_inliers and a pose; then SS_REPS repeats of SS_STEPS
       steps cycled over pairs 1-11 ending in one value fetch give
       stereo_tracked_fps (median, min), the launches counted over the
       first. Also the depth funnel on pair 0 (tests/stereo_step_world.py),
       host syncs a step against the mono step's on the same world
       (``count_syncs``), kernels a step and the device busy share under
       torch.profiler, the device ms of the stereo match stage (events, and
       its busy ms and kernels under the profiler) and of K1 at B = 2 (this
       pair's levels), and peak memory. Gates: pair 0's
       fraction within SS_FRAC_ATOL of the JAX package's CPU run (SS_JAX),
       pair 1's inliers at least SS_INLIER_SHARE of JAX's, its translation
       within SS_T_ATOL of JAX's and of ground truth, the batched K1 and K2
       once a step (none of the one-frame K1), no more host syncs than the
       mono step.
    2. ``stereo_step_local_map``: the same world with ``local_map=True`` and
       a 4096-slot arena holding frame 0's landmarks, as CompiledSLAM will
       call the step: SS_SHORT steps, K3 once a step besides K1 and K2, pair
       1 within SS_T_ATOL of ground truth.
    3. ``stereo_chunk``: ``make_track_chunk`` over pairs 1-8; its poses
       equal those of 8 single steps from the same generator seed within
       SS_CHUNK_ATOL; chunk FPS over SS_REPS repeats of SS_SHORT // 8
       chunks.
    4. ``stereo_batched``: ``make_batched_vo(stereo=True)`` over SS_B worlds
       (seeds 5 + s, generator seed s), bench's run on each: aggregate FPS
       over SS_REPS repeats of MS_STEPS steps, efficiency against SS_B x the single step's
       FPS, launches a batched step (the batched K1 once, for 2 x SS_B
       frames; K2 paired once; nothing one-sequence); at B = 1 the batched
       step on pair 1 equals the single step in every output but the pose,
       and that within SS_B1_POSE_ATOL (the batched solve's small products
       round otherwise).
    Returns the launches of the counted runs (the first timed repeat of 1,
    the run of 2, the first of 4): the single steps' batched K1 at B = 2,
    K2 and K3 ("k1_b2", "k2", "k3"), the batched step's K1 at B = 2 x SS_B
    ("k1_b8"); and the 2 x SS_B frames of the batched step's pair 1
    ("b8_frames", numpy), for the K1 row at that shape."""
    import stereo_step_world as ssw

    from visual_slam_tpu_torch import pipeline
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels
    from visual_slam_tpu_torch.parallel import make_batched_vo

    t_phase = time.perf_counter()
    counters = {"k1_batched": patches_and_moments_batched, "k1_levels": patches_and_moments_levels,
                "k2": mk.hamming_top2, "k3": mk.guided_top2, "k2_paired": mk.hamming_top2_paired,
                "k3_batched": mk.guided_top2_batched}

    def reset():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in counters.items()}

    pairs_np, K, Ts = ssw.bench_world()
    pairs = torch.from_numpy(pairs_np).to(dev)
    cycle = pairs[1:]
    step = pipeline.make_track_step(K, device=dev, **ssw.step_kwargs())
    mono = pipeline.make_track_step(K, device=dev, num_features=N_FEATURES, n_levels=N_LEVELS)
    make_state, out0, feats0 = stereo_states(torch, np, step, pairs, K, dev)
    z_ok = (out0.kp_z_valid & out0.features.valid).cpu().numpy()
    frac = float(z_ok.mean())
    fl, fr = step.detect_pair(pairs[0])
    bf = ssw.BASELINE * float(K[0, 0])
    funnel = ssw.depth_funnel(*[a.cpu().numpy() for f in (fl, fr) for a in (f.xy, f.desc, f.valid)], bf)
    funnel_vs_step = int((funnel.pop("valid_slots") != z_ok).sum())

    # 1. bench's run: pair 1, then the timed steps, the first counted.
    _, out1 = step(make_state(), pairs[1])
    T1 = out1.T_w2c.cpu().numpy()
    n_inl1 = int(out1.n_inliers)
    torch.cuda.reset_peak_memory_stats()
    reset()
    fps = [stepped_fps(step, make_state, cycle, SS_STEPS)]
    launches = read()
    fps += [stepped_fps(step, make_state, cycle, SS_STEPS) for _ in range(SS_REPS - 1)]
    peak = torch.cuda.max_memory_allocated() / 2**20
    counted = dict(launches)
    costs = step_costs(torch, {"stereo": cycling(step, make_state(), cycle),
                               "mono": cycling(mono, make_state(), cycle[:, 0])}, MS_PROFILE_STEPS)
    n_sync = {name: sum(c["syncs"].values()) for name, c in costs.items()}
    fl1, fr1 = step.detect_pair(pairs[1])
    match_ms, match_gapless = device_ms(lambda: step.stereo_depths(fl1, fr1), n=50)
    match_prof = profile_calls(torch, lambda: step.stereo_depths(fl1, fr1), 20)
    k1_args = batched_k1_args(torch, np, list(pairs_np[1]))
    k1_ms, k1_gapless = device_ms(lambda: patches_and_moments_batched(*k1_args), n=50)
    t_err = float(np.linalg.norm(T1[:3, 3] - Ts[1][:3, 3]))
    t_vs_jax = float(np.linalg.norm(T1[:3, 3] - np.asarray(SS_JAX["pair1_t"])))
    per_step = {k: v / SS_STEPS for k, v in launches.items()}
    rep = dict(phase="stereo_step", world="bench_stereo_step", size=[H, W], features=N_FEATURES, steps=SS_STEPS,
               stereo_tracked_fps_median=statistics.median(fps), stereo_tracked_fps_min=min(fps), fps_reps=fps,
               stereo_kp_z_valid_frac=frac, stereo_n_inliers=n_inl1, jax_cpu=SS_JAX,
               pair1_t=T1[:3, 3].tolist(), pair1_t_err_m=t_err, pair1_t_vs_jax_m=t_vs_jax,
               funnel_pair0=funnel, funnel_vs_step_mismatches=funnel_vs_step,
               syncs_per_step=n_sync, syncs_by_line_stereo=costs["stereo"]["syncs"],
               launches_per_step=per_step, kernels_per_step={k: c["kernels_per_call"] for k, c in costs.items()},
               busy_share_profiled={k: c["busy_share"] for k, c in costs.items()},
               host_span_ms_stereo=costs["stereo"]["host_span_ms_per_call"],
               stereo_match_device_ms=match_ms, stereo_match_gapless=match_gapless,
               stereo_match_busy_ms_profiled=match_prof["busy_ms_per_call"],
               stereo_match_kernels=match_prof["kernels_per_call"],
               k1_b2_device_ms=k1_ms, k1_b2_gapless=k1_gapless, peak_mib=peak)
    log(json.dumps(rep))
    if funnel_vs_step:
        raise AssertionError(f"stereo step: the funnel's depth-valid slots differ from the step's on {funnel_vs_step}")
    if abs(frac - SS_JAX["kp_z_valid_frac"]) > SS_FRAC_ATOL:
        raise AssertionError(f"stereo step: kp_z_valid_frac {frac} against JAX's {SS_JAX['kp_z_valid_frac']}")
    if n_inl1 < SS_INLIER_SHARE * SS_JAX["n_inliers"]:
        raise AssertionError(f"stereo step: {n_inl1} inliers at pair 1, under {SS_INLIER_SHARE} x JAX's "
                             f"{SS_JAX['n_inliers']}")
    if not np.isfinite(T1).all() or t_err > SS_T_ATOL or t_vs_jax > SS_T_ATOL:
        raise AssertionError(f"stereo step: pair 1 translation {T1[:3, 3]} off ground truth by {t_err} m, off JAX's "
                             f"by {t_vs_jax} m (bound {SS_T_ATOL})")
    expected = {"k1_batched": SS_STEPS, "k1_levels": 0, "k2": SS_STEPS, "k3": 0, "k2_paired": 0, "k3_batched": 0}
    if launches != expected:
        raise AssertionError(f"stereo step launches {launches} != {expected}")
    if n_sync["stereo"] > n_sync["mono"]:
        raise AssertionError(f"stereo step: {costs['stereo']['syncs']} host syncs a step, more than the mono step's "
                             f"{costs['mono']['syncs']}")

    # 2. The local map: the arena holds frame 0's landmarks.
    step_lm = pipeline.make_track_step(K, device=dev, local_map=True, width=W, height=H, **ssw.step_kwargs())
    make_lm, _, _ = stereo_states(torch, np, step_lm, pairs, K, dev, local_map=True)
    _, o1 = step_lm(make_lm(), pairs[1])
    T1_lm = o1.T_w2c.cpu().numpy()
    reset()
    fps_lm = stepped_fps(step_lm, make_lm, cycle, SS_SHORT)
    launches = read()
    for k in ("k1_batched", "k2", "k3"):
        counted[k] += launches[k]
    t_err_lm = float(np.linalg.norm(T1_lm[:3, 3] - Ts[1][:3, 3]))
    rep = dict(phase="stereo_step_local_map", arena=ARENA, steps=SS_SHORT, fps=fps_lm,
               pair1_n_inliers=int(o1.n_inliers), pair1_guided=int(o1.guided_valid.sum()), pair1_t_err_m=t_err_lm,
               launches_per_step={k: v / SS_SHORT for k, v in launches.items()})
    log(json.dumps(rep))
    expected = {"k1_batched": SS_SHORT, "k1_levels": 0, "k2": SS_SHORT, "k3": SS_SHORT, "k2_paired": 0, "k3_batched": 0}
    if launches != expected:
        raise AssertionError(f"stereo step with the local map: launches {launches} != {expected}")
    if not np.isfinite(T1_lm).all() or t_err_lm > SS_T_ATOL or not bool(o1.guided_valid.any()):
        raise AssertionError(f"stereo step with the local map: pair 1 off ground truth by {t_err_lm} m, or no guided "
                             "pair")

    # 3. Chunks of 8 pairs.
    chunk = pipeline.make_track_chunk(step)
    imgs = pairs[1:1 + SS_CHUNK]
    _, outs = chunk(make_state(seed=7), imgs)
    s, T_single = make_state(seed=7), []
    for img in imgs:
        s, o = step(s, img)
        T_single.append(o.T_w2c)
    d_chunk = float((outs.T_w2c - torch.stack(T_single)).abs().max())
    n_chunks = SS_SHORT // SS_CHUNK
    chunk_fps = []
    for _ in range(SS_REPS):
        s = make_state()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            s, outs = chunk(s, imgs)
        float(outs.T_w2c[-1, 0, 0])
        chunk_fps.append(n_chunks * SS_CHUNK / (time.perf_counter() - t0))
    rep = dict(phase="stereo_chunk", chunk=SS_CHUNK, chunks=n_chunks, chunk_fps_median=statistics.median(chunk_fps),
               chunk_fps_min=min(chunk_fps), chunk_fps_reps=chunk_fps, chunk_vs_single_max_abs=d_chunk)
    log(json.dumps(rep))
    if not d_chunk <= SS_CHUNK_ATOL:
        raise AssertionError(f"stereo chunk: poses off the single steps' by {d_chunk} (bound {SS_CHUNK_ATOL})")

    # 4. Batched: SS_B worlds, bench's run on each.
    worlds_np = [pairs_np] + [ssw.bench_world(seed=ssw.SEED + b)[0] for b in range(1, SS_B)]
    worlds = [pairs] + [torch.from_numpy(w).to(dev) for w in worlds_np[1:]]
    makers = [make_state] + [stereo_states(torch, np, step, w, K, dev, seed=b)[0] for b, w in enumerate(worlds) if b]
    bstep = make_batched_vo(K, device=dev, **ssw.step_kwargs())
    bcycle = torch.stack([w[1:] for w in worlds], 1)  # (pairs, B, 2, H, W)

    def stacked():
        return pipeline.stack_track_states([make(seed=b) for b, make in enumerate(makers)])

    # At B = 1 against the single step, pair 1 from the same state and seed.
    _, ob = bstep(pipeline.stack_track_states([make_state(seed=3)]), pairs[1:2])
    _, o = step(make_state(seed=3), pairs[1])
    ob = pipeline.split_track_outputs(ob)[0]
    b1_diff = [name for name, a, b in zip(o._fields, ob, o) if name != "T_w2c" and not (
        all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(b, tuple) else torch.equal(a, b))]
    b1_pose = float((ob.T_w2c - o.T_w2c).abs().max())
    bstep(stacked(), bcycle[0])  # warm-up
    reset()
    agg = [stepped_fps(bstep, stacked, bcycle, MS_STEPS, SS_B)]
    launches = read()
    agg += [stepped_fps(bstep, stacked, bcycle, MS_STEPS, SS_B) for _ in range(SS_REPS - 1)]
    single = statistics.median(fps)
    rep = dict(phase="stereo_batched", B=SS_B, steps=MS_STEPS, agg_fps_median=statistics.median(agg),
               agg_fps_min=min(agg), agg_fps_reps=agg, single_fps_median=single,
               efficiency=statistics.median(agg) / (SS_B * single),
               launches_per_step={k: v / MS_STEPS for k, v in launches.items()},
               b1_fields_differing=b1_diff, b1_pose_max_abs=b1_pose)
    log(json.dumps(rep))
    expected = {"k1_batched": MS_STEPS, "k1_levels": 0, "k2": 0, "k3": 0, "k2_paired": MS_STEPS, "k3_batched": 0}
    if launches != expected:
        raise AssertionError(f"stereo batched step launches {launches} != {expected}")
    if b1_diff or not b1_pose <= SS_B1_POSE_ATOL:
        raise AssertionError(f"stereo batched step at B = 1: {b1_diff} differ from the single step, pose by {b1_pose}")
    log(f"stereo step phases: {time.perf_counter() - t_phase:.1f} s")
    return {"k1_b2": counted["k1_batched"], "k2": counted["k2"], "k3": counted["k3"], "k1_b8": launches["k1_batched"],
            "b8_frames": [f for w in worlds_np for f in w[1]]}


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


def boundary_stages(slam, cs_mod):
    """Host ms by chunk-boundary stage of ``slam`` while ``timing["on"]``:
    launching the chunk's steps, the compaction, the fetch (the wait for the
    device), adoption, the landmark budget, the heavy BA, re-installing the
    state. Returns (stage_ms, timing, undo); ``undo`` restores the module's
    fetch."""
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

    def undo():
        cs_mod.to_host = fetch0

    return stage_ms, timing, undo


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

    stage_ms, timing, undo_stages = boundary_stages(slam, cs_mod)
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
    undo_stages()
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


def run_stereo_pipeline(torch, np, dev, k1_batched, k1_levels, k2, k3) -> dict:
    """bench_stereo_pipeline through the port's entry points on the card,
    uncut: ``CompiledSLAM(camera, config).track([left, right], t)`` per pair,
    ``flush()`` and ``trajectory()``; the bootstrap, warm-up and timed
    window of the bench (tests/stereo_pipeline_world.py). Prints the FPS,
    the metric ATE, keyframes, landmarks, the bootstrap pair, LOST pairs,
    the device-minted slots per promotion, double mints, BA solves over the
    landmark cap and the largest map, host syncs per chunk over the warm-up
    (against the mono full pipeline's), K1 / K2 / K3 launches per pair and
    peak device memory. Returns the report, with the run's launches of the
    four wrappers; raises if a gate fails."""
    import stereo_pipeline_world as spw

    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.models import CompiledSLAM
    from visual_slam_tpu_torch.models import compiled_slam as cs_mod
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    t_phase = time.perf_counter()
    lefts, rights, K, Ts_gt = spw.stereo_frames()
    n = len(lefts)
    log(f"stereo pipeline world: {n} pairs {lefts.shape[1:]}, baseline {spw.BASELINE} m, rendered in "
        f"{time.perf_counter() - t_phase:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    slam = CompiledSLAM(spw.camera(PinholeCamera, lefts, K), spw.config(Config), device=dev)
    if not slam._stereo:
        raise AssertionError("stereo pipeline: the system did not build the stereo step")
    probe = spw.Probe(slam)
    seen = collections.Counter()
    tracker, step = slam._feature_tracker, slam._step
    detect0, match0, forward0, brute0, run_chunk0 = (tracker.detectAndCompute, tracker.match, step.forward,
                                                     slam._brute_recover, slam._run_chunk)

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

    tracker.detectAndCompute, tracker.match, step.forward = detect, match, forward
    slam._brute_recover, slam._run_chunk = brute, run_chunk
    stage_ms, timing, undo_stages = boundary_stages(slam, cs_mod)
    counters = (k1_batched, k1_levels, k2, k3)
    before = [c.launches for c in counters]
    states = {}

    def track(k):
        states[k] = slam.track([lefts[k], rights[k]], timestamp=k * spw.DT)["state"]

    i = 0
    t0 = time.perf_counter()
    while slam.state.name != "OK" and i < spw.BOOT_FRAMES:
        track(i)
        i += 1
    if slam.state.name != "OK":
        raise AssertionError(f"stereo pipeline: no bootstrap in the first {spw.BOOT_FRAMES} pairs")
    boot = i - 1
    log(f"stereo pipeline: bootstrap on pair {boot} ({time.perf_counter() - t0:.2f} s): "
        f"{slam.map.num_keyframes()} keyframe, {slam.map.num_map_points()} landmarks")
    warm_end, n_end = spw.schedule(i, n)
    chunks0 = seen["chunk"]
    t0 = time.perf_counter()
    with count_syncs(torch) as sync_at:
        while i < warm_end:
            track(i)
            i += 1
        torch.cuda.synchronize()
    n_warm = seen["chunk"] - chunks0
    syncs_per_chunk = sum(sync_at.values()) / max(n_warm, 1)
    log(f"stereo pipeline: warm-up pairs {boot + 1}-{warm_end - 1} ({time.perf_counter() - t0:.2f} s): {n_warm} "
        f"chunk boundaries; host syncs per chunk {syncs_per_chunk:.1f} (mono full pipeline "
        f"{MONO_FP_SYNCS_PER_CHUNK}), by source line {dict(sync_at.most_common())}")
    chunks0 = seen["chunk"]
    torch.cuda.synchronize()
    timing["on"] = True
    t0 = time.perf_counter()
    for k in range(i, n_end):
        track(k)
    slam.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timing["on"] = False
    undo_stages()
    n_timed = n_end - i
    n_chunks = max(seen["chunk"] - chunks0, 1)
    chunk_stage_ms = {k: round(v / n_chunks, 2) for k, v in stage_ms.items()}
    chunk_stage_ms["other"] = round(dt * 1e3 / n_chunks - sum(stage_ms.values()) / n_chunks, 2)
    ts, Ts = slam.trajectory()
    rmse, ate_pct, path = spw.metric_ate(ate_rmse, ts, Ts, Ts_gt)
    rmse_sim, scale = spw.scale_fit(ate_rmse, ts, Ts, Ts_gt)
    launches = [c.launches - b for c, b in zip(counters, before)]
    pairs = seen["detect"] + seen["step"]
    lost = sorted(k for k, st in states.items() if st == "LOST")
    report = dict(stereo_pipeline_fps=n_timed / dt, stereo_pipeline_ate_pct_of_path_metric=ate_pct,
                  ate_rmse_m=rmse, path_m=path, ate_scale_aligned_m=rmse_sim, fitted_scale=scale,
                  keyframe_centre_err_m=spw.keyframe_errors(slam.map.get_keyframes(), Ts_gt),
                  frames_timed=n_timed, chunk_ms=dt * 1e3 / n_chunks, chunk_stage_ms=chunk_stage_ms,
                  keyframes=slam.map.num_keyframes(), landmarks=slam.map.num_map_points(), bootstrap_frame=boot,
                  lost_frames=lost, final_state=slam.state.name, syncs_per_chunk=syncs_per_chunk,
                  brute_recoveries=seen["brute"], launches_k1_batched_k1_levels_k2_k3=launches,
                  k1_k2_k3_per_pair=[round(launches[0] / pairs, 3), round(launches[2] / pairs, 3),
                                     round(launches[3] / pairs, 3)],
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20, ba_shapes=sorted(slam.optimizer.shapes_seen),
                  **probe.summary())
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"stereo pipeline: {json.dumps(report)}")
    log(f"stereo pipeline: FPS {report['stereo_pipeline_fps']:.2f} ({n_timed} pairs timed in {dt:.3f} s, flush "
        f"inside, {report['chunk_ms']:.1f} ms a chunk: {chunk_stage_ms}), metric ATE {rmse:.4f} m = "
        f"{ate_pct:.3f} % of a "
        f"{path:.2f} m path (JAX on the CPU {SP_JAX['ate_pct']} %), {report['keyframes']} keyframes, "
        f"{report['landmarks']} landmarks (largest map {probe.largest_map}; BA solves over the "
        f"{spw.MAX_POINTS}-landmark cap {probe.cap_hits}, the largest handed {probe.largest_solve}), device-minted "
        f"slots per promotion {probe.minted}, double mints {probe.double_mints}, LOST pairs {lost}, peak device "
        f"memory {report['peak_mib']:.1f} MiB, phase {report['phase_s']:.1f} s")
    expected = [pairs, 0, seen["match"] + seen["step"] + seen["brute_match"], seen["step"]]
    log(f"stereo pipeline launches K1 batched, K1 one-frame, K2, K3: {launches} (expected {expected}: "
        f"{seen['detect']} bootstrap pair detects, {seen['step']} steps, {seen['match']} bootstrap matches, "
        f"{seen['brute_match']} brute-recovery matches)")

    ate_max = max(2 * SP_JAX["ate_pct"], SP_ATE_PCT_FLOOR)
    if boot != SP_JAX["bootstrap_frame"]:
        raise AssertionError(f"stereo pipeline: bootstrap on pair {boot}, JAX's on {SP_JAX['bootstrap_frame']}")
    if lost or slam.state.name != "OK":
        raise AssertionError(f"stereo pipeline: LOST pairs {lost}, final state {slam.state.name}")
    if not (len(ts) == n_end - boot and np.allclose(ts, spw.DT * np.arange(boot, n_end))):
        raise AssertionError(f"stereo pipeline: pairs {boot}-{n_end - 1} should each have one pose")
    if not np.isfinite(Ts).all():
        raise AssertionError("stereo pipeline: non-finite poses in the trajectory")
    if not probe.minted or not sum(probe.minted):
        raise AssertionError(f"stereo pipeline: no device-minted slot ({probe.minted})")
    if launches != expected:
        raise AssertionError(f"stereo pipeline launches {launches} != {expected}")
    if not ate_pct <= ate_max:
        # Raised by main() after the later phases have run, so that this
        # run's ATE does not hide their results.
        report["gate_failed"] = f"stereo pipeline: metric ATE {ate_pct:.3f} % of path above {ate_max} %"
        log(f"FAILED: {report['gate_failed']}")
    return report


def run_rgbd_pipeline(torch, np, dev, card, world, k1_levels, k1_batched, k2, k3) -> dict:
    """TUM1's world through RGB-D ``CompiledSLAM`` on the card
    (tests/rgbd_pipeline_world.py): ``CompiledSLAM(camera, config).track([image],
    t, depth)`` per frame, ``flush()`` and ``trajectory()``; the bootstrap,
    one warm-up chunk (host syncs counted there), then the rest of the 32
    frames timed with ``flush()`` inside. ``world`` is (images, depth maps,
    K, T_w2c ground truth). Prints the FPS, a chunk's ms by boundary stage,
    syncs a chunk, the metric ATE, keyframes, landmarks, heavy boundaries, BA
    solves, LOST frames, K1 / K2 / K3 launches a frame and peak memory,
    each beside ``card``. Returns the report with the run's launches of the
    four wrappers (counts set to 0 just before the run); raises if a gate
    fails."""
    import rgbd_pipeline_world as rpw

    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.models import CompiledSLAM
    from visual_slam_tpu_torch.models import compiled_slam as cs_mod
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    t_phase = time.perf_counter()
    imgs, depths, K, Ts_gt = world
    n = len(imgs)
    torch.cuda.reset_peak_memory_stats()
    slam = CompiledSLAM(rpw.camera(PinholeCamera, imgs, K), rpw.tum_config(Config), device=dev)
    if slam._stereo or slam._step.stereo:
        raise AssertionError("RGB-D pipeline: the system did not build the mono step")
    probe = rpw.Probe(slam)
    seen = collections.Counter()
    tracker, step = slam._feature_tracker, slam._step
    detect0, match0, forward0, brute0, run_chunk0 = (tracker.detectAndCompute, tracker.match, step.forward,
                                                     slam._brute_recover, slam._run_chunk)

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

    tracker.detectAndCompute, tracker.match, step.forward = detect, match, forward
    slam._brute_recover, slam._run_chunk = brute, run_chunk
    stage_ms, timing, undo_stages = boundary_stages(slam, cs_mod)
    counters = (k1_levels, k1_batched, k2, k3)
    marks, syncs = {}, contextlib.ExitStack()

    def on_frame(phase, i):
        if phase in marks:
            return
        torch.cuda.synchronize()
        marks[phase] = (time.perf_counter(), i, seen["chunk"])
        if phase == "warm":
            marks["sync_at"] = syncs.enter_context(count_syncs(torch))
        elif phase == "timed":
            syncs.close()
            timing["on"] = True
        elif phase == "flushed":
            timing["on"] = False

    for fn in counters:
        fn.launches = 0
    with syncs:
        res = rpw.run(slam, imgs, depths, on_frame)
    launches = [fn.launches for fn in counters]
    undo_stages()
    boot = res["bootstrap_frame"]
    if boot is None:
        raise AssertionError(f"RGB-D pipeline: no bootstrap in the first {rpw.BOOT_FRAMES} frames")
    sync_at = marks["sync_at"]
    n_warm = marks["timed"][2] - marks["warm"][2]
    syncs_per_chunk = sum(sync_at.values()) / max(n_warm, 1)
    (t_timed, i_timed, c_timed), (t_end, _, c_end) = marks["timed"], marks["flushed"]
    dt, n_timed, n_chunks = t_end - t_timed, n - i_timed, max(c_end - c_timed, 1)
    chunk_stage_ms = {k: round(v / n_chunks, 2) for k, v in stage_ms.items()}
    chunk_stage_ms["other"] = round(dt * 1e3 / n_chunks - sum(stage_ms.values()) / n_chunks, 2)
    ts, Ts = slam.trajectory()
    rmse, ate_pct, path = rpw.metric_ate(ate_rmse, ts, Ts, Ts_gt)
    rmse_sim, scale = rpw.scale_fit(ate_rmse, ts, Ts, Ts_gt)
    lost = rpw.lost_frames(res["states"])
    # flush() runs the last partial chunk as a full one: its padding slots are
    # steps too (K1, K2 and K3 each launch there once more).
    pad = -(n - 1 - boot) % slam.config.tracking.chunk_size
    report = dict(card=card, rgbd_pipeline_fps=n_timed / dt, rgbd_pipeline_ate_pct_of_path_metric=ate_pct,
                  ate_rmse_m=rmse, path_m=path, ate_scale_aligned_m=rmse_sim, fitted_scale=scale,
                  frames_timed=n_timed, chunks_timed=n_chunks, chunk_ms=dt * 1e3 / n_chunks,
                  chunk_stage_ms=chunk_stage_ms, syncs_per_chunk=syncs_per_chunk, warm_chunks=n_warm,
                  syncs_by_line=dict(sync_at.most_common()), keyframes=slam.map.num_keyframes(),
                  landmarks=slam.map.num_map_points(), bootstrap_frame=boot,
                  bootstrap_landmarks=res["bootstrap_landmarks"],
                  arena_valid_at_end=int(slam._track_state.lm_valid.sum()),
                  lost_frames=lost, final_state=slam.state.name, brute_recoveries=seen["brute"],
                  launches_k1_levels_k1_batched_k2_k3=launches, steps=seen["step"], padded_steps=pad,
                  k1_k2_k3_per_frame=[round(launches[0] / n, 3), round(launches[2] / n, 3), round(launches[3] / n, 3)],
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20, ba_shapes=sorted(slam.optimizer.shapes_seen),
                  **probe.summary())
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"RGB-D pipeline: {json.dumps(report)}")
    log(f"RGB-D pipeline ({card}): FPS {report['rgbd_pipeline_fps']:.2f} ({n_timed} frames timed in {dt:.3f} s, "
        f"flush inside, {report['chunk_ms']:.1f} ms a chunk over {n_chunks}: {chunk_stage_ms}), host syncs per "
        f"chunk {syncs_per_chunk:.1f} (mono full pipeline {MONO_FP_SYNCS_PER_CHUNK}), metric ATE {rmse:.4f} m = "
        f"{ate_pct:.3f} % of a {path:.2f} m path (JAX on the CPU {RP_JAX['ate_pct']} %), {report['keyframes']} "
        f"keyframes, {report['landmarks']} landmarks, {probe.heavy_boundaries} heavy boundaries, {probe.ba_solves} "
        f"BA solves, device-minted slots per promotion {probe.minted}, LOST frames {lost}, K1 / K2 / K3 a frame "
        f"{report['k1_k2_k3_per_frame']} over {n} frames, peak device memory {report['peak_mib']:.1f} MiB, phase "
        f"{report['phase_s']:.1f} s")
    expected = [seen["detect"] + seen["step"], 0, seen["match"] + seen["step"] + seen["brute_match"], seen["step"]]
    log(f"RGB-D pipeline launches K1 one-frame, K1 batched, K2, K3: {launches} (expected {expected}: "
        f"{seen['detect']} bootstrap detects, {seen['step']} steps ({pad} of them the flushed chunk's padding), "
        f"{seen['match']} bootstrap matches, {seen['brute_match']} brute-recovery matches)")

    ate_max = max(2 * RP_JAX["ate_pct"], RP_ATE_PCT_FLOOR)
    if boot != RP_JAX["bootstrap_frame"]:
        raise AssertionError(f"RGB-D pipeline: bootstrap on frame {boot}, JAX's on {RP_JAX['bootstrap_frame']}")
    if lost or slam.state.name != "OK":
        raise AssertionError(f"RGB-D pipeline: LOST frames {lost}, final state {slam.state.name}")
    if not (len(ts) == n - boot and np.allclose(ts, rpw.DT * np.arange(boot, n))):
        raise AssertionError(f"RGB-D pipeline: frames {boot}-{n - 1} should each have one pose")
    if not np.isfinite(Ts).all():
        raise AssertionError("RGB-D pipeline: non-finite poses in the trajectory")
    if not ate_pct <= ate_max:
        raise AssertionError(f"RGB-D pipeline: metric ATE {ate_pct:.3f} % of path above {ate_max} %")
    if not (probe.heavy_boundaries and probe.ba_solves):
        raise AssertionError(f"RGB-D pipeline: {probe.heavy_boundaries} heavy boundaries, {probe.ba_solves} BA solves")
    if seen["step"] != n - 1 - boot + pad:
        raise AssertionError(f"RGB-D pipeline: {seen['step']} steps for {n - 1 - boot} frames and {pad} padding")
    if launches != expected:
        raise AssertionError(f"RGB-D pipeline launches {launches} != {expected}")
    return report


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
                  last_states=states[-2:],
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
        n = len(eframes) if loop_on or ENDURANCE_JAX_ON_BELOW_OFF else ENDURANCE_OFF_FRAMES
        slam, r = facade_run(torch, np, dev, counters, eframes[:n], eK, eTs[:n], fw.endurance_config(Config, loop_on))
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
        check_facade_launches("endurance", r, n - r["boot_frame"] - 1 - r["lost_after_boot"])
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

    out, states, _ = run_processing(torch, np, dev, counters, Frames(frames[:PROCESSING_FRAMES]), K,
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


def run_depth_facade_phases(torch, np, dev, counters, rgbd_world):
    """The stereo and RGB-D host facade (``SLAM``) on the card: each sensor's
    world at the default RANSAC seed and DEPTH_SEEDS with ``MonoTracking``,
    then one fused run, each classed and printed; then ``Processing`` over
    an in-memory source of each world. ``counters`` are the K1-K5 wrappers
    (K1 a ``LaunchSum`` of the one-frame and batched wrappers);
    ``rgbd_world`` is ``depth_world.rgbd_frames(RGBD_FRAMES)``. Returns, per
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
    imgs, depths, rK, rTs = rgbd_world
    log(f"rendered the stereo world ({len(lefts)} pairs, {lefts[0].shape}) in {time.perf_counter() - t0:.2f} s")
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
        out, states, _ = run_processing(torch, np, dev, counters, source, K, config(Config), p1)
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


def ff_parity(torch, np, name, cpu, card) -> dict:
    """Card against CPU features of one detector: the shared keypoints (each
    valid CPU keypoint with a valid card keypoint at the same position,
    within the family's tolerance, and octave, in whatever slot: one
    keypoint more or less shifts every weaker one by a slot), and on them
    the angle and descriptor agreement."""
    tol = FF_TOL[name]
    c = {k: getattr(card, k).cpu().numpy() for k in ("xy", "angle", "octave", "desc", "valid")}
    h = {k: getattr(cpu, k).numpy() for k in ("xy", "angle", "octave", "desc", "valid")}
    ih, ic = np.nonzero(h["valid"])[0], np.nonzero(c["valid"])[0]
    d = np.abs(h["xy"][ih][:, None, :] - c["xy"][ic][None, :, :]).max(axis=-1)
    d = np.where(h["octave"][ih][:, None] == c["octave"][ic][None, :], d, np.inf)
    j = d.argmin(axis=1)
    ok = d[np.arange(len(ih)), j] <= tol["xy"]
    ih, ic = ih[ok], ic[j[ok]]
    gap = np.abs(h["angle"][ih] - c["angle"][ic])
    gap = np.minimum(gap, 2 * np.pi - gap)
    out = {"valid_cpu": int(h["valid"].sum()), "valid_card": int(c["valid"].sum()),
           "same_share": float(len(ih) / max(h["valid"].sum(), 1)), "angle_max": float(gap.max(initial=0.0)),
           "angle_share": float((gap <= tol["angle"]).mean())}
    if "desc" in tol:
        dd = np.abs(h["desc"][ih].view(np.float32) - c["desc"][ic].view(np.float32)).max(axis=1)
        out.update(desc_max=float(dd.max(initial=0.0)), desc_share=float((dd <= tol["desc"]).mean()))
    else:
        def bits(w):
            return (np.ascontiguousarray(w).view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1

        out["bit_share"] = float((bits(h["desc"][ih]) == bits(c["desc"][ic])).mean())
    return out


def ff_detectors(torch, np, dev, frame, k1) -> int:
    """Part a: each family's detector on the card and on the CPU at the
    deploy width, printed and gated (FF_TOL); returns the K1 launches."""
    from visual_slam_tpu_torch.frontend import feature_manager as tfm

    img = torch.from_numpy(frame).to(dev)
    launches = 0
    params = dict(num_features=N_FEATURES, n_levels=N_LEVELS, grid=GRID)
    for name in ("shi_tomasi_orb", "gradhist", "shi_tomasi_gradhist", "sift"):
        kw = dict(num_features=N_FEATURES, n_octaves=3, contrast_threshold=0.02) if name == "sift" else params
        t0 = time.perf_counter()
        cpu = tfm.feature_factory(name, device="cpu", **kw).detectAndCompute(frame)
        cpu_s = time.perf_counter() - t0
        det = tfm.feature_factory(name, device=dev, **kw)
        det.detectAndCompute(img)  # first call: the card's allocator and constants
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        card = det.detectAndCompute(img)
        torch.cuda.synchronize()
        one = k1.launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        med, mn = timed(lambda: det.detectAndCompute(img), reps=FF_DET_REPS, warmup=1)
        launches += k1.launches
        par = ff_parity(torch, np, name, cpu, card)
        log(json.dumps({"phase": "feature_families_detect", "detector": name, "desc_words": det.desc_words,
                        **par, "detect_ms": med, "detect_ms_min": mn, "reps": FF_DET_REPS, "peak_mib": peak,
                        "k1_per_detect": one, "cpu_detect_s": cpu_s}))
        if one != (1 if name == "shi_tomasi_orb" else 0):
            raise AssertionError(f"{name}: K1 launched {one} times in one detect")
        if par["same_share"] < FF_SHARE_MIN or par["angle_share"] < FF_SHARE_MIN:
            raise AssertionError(f"{name}: card against CPU {par}")
        if par.get("desc_share", 1.0) < FF_SHARE_MIN or par.get("bit_share", 1.0) < FF_BIT_SHARE_MIN:
            raise AssertionError(f"{name}: card descriptors against the CPU's {par}")
    return launches


def ff_ivf(torch, np, dev):
    """Part b: the IVF index at FlannMatcher's scale on the card: build and
    search times, recall against the exact match, no invalid row matched,
    the search equal to its CPU run."""
    from visual_slam_tpu_torch.ops.ann import build_ivf_index, ivf_search
    from visual_slam_tpu_torch.ops.matching import _nn_ok, hamming_top2

    # tests/test_ann.py's draws (_random_db, _perturb), in the same order.
    rng = np.random.default_rng(0)
    db = rng.integers(0, 2**32, size=(FF_IVF_ROWS, 8), dtype=np.uint32)
    valid = np.ones(FF_IVF_ROWS, bool)
    valid[-32:] = False
    q_rows = rng.choice(np.nonzero(valid)[0], size=FF_IVF_QUERIES, replace=False)
    q = db[q_rows].copy()
    for _ in range(8):
        word, bit = rng.integers(0, 8), rng.integers(0, 32)
        q[:, word] ^= np.uint32(1 << bit) * rng.integers(0, 2, q.shape[0]).astype(np.uint32)
    desc, qdesc = db.view(np.int32), q.view(np.int32)
    t = {d: [torch.from_numpy(a).to(d) for a in (desc, valid, qdesc)] for d in ("cpu", dev)}
    d_c, v_c, q_c = t[dev]
    q_ok = torch.ones(FF_IVF_QUERIES, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_ivf_index(d_c, v_c, n_clusters=FF_IVF_CLUSTERS)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3

    def search():
        return ivf_search(index, q_c, q_ok, n_probe=FF_IVF_PROBES, ratio=0.9)

    res = search()
    wall, _ = timed(search, reps=REPS)
    dev_ms, gapless = device_ms(search, n=20)
    # The exact match: K2 against all FF_IVF_ROWS train rows, with the ratio
    # test and without the cross-check, as match_nn on the dense matrix.
    best, second, ti_e, colarg = hamming_top2(q_c, d_c, q_ok, v_c)
    ok_e = _nn_ok(best, second, ti_e, colarg, 0.9, False, 0.0)
    ti, ok = res["train_idx"].cpu().numpy(), res["valid"].cpu().numpy()
    ti_e, ok_e = ti_e.cpu().numpy(), ok_e.cpu().numpy()
    recall = float((ok & (ti == ti_e))[ok_e].mean())
    planted = float((ok & (ti == q_rows)).mean())
    tail = ivf_search(index, d_c[-16:], q_ok[:16], n_probe=FF_IVF_PROBES, ratio=0.0)
    t_ti, t_ok = tail["train_idx"].cpu().numpy(), tail["valid"].cpu().numpy()
    cpu_index = build_ivf_index(t["cpu"][0], t["cpu"][1], n_clusters=FF_IVF_CLUSTERS)
    same_index = all(torch.equal(a.cpu(), b) for a, b in zip(index, cpu_index))
    cpu_res = ivf_search(cpu_index, t["cpu"][2], torch.ones(FF_IVF_QUERIES, dtype=torch.bool), n_probe=FF_IVF_PROBES,
                         ratio=0.9)
    same_search = all(torch.equal(res[k].cpu(), cpu_res[k]) for k in ("train_idx", "distance", "valid"))
    log(json.dumps({"phase": "feature_families_ivf", "rows": FF_IVF_ROWS, "queries": FF_IVF_QUERIES,
                    "clusters": index.n_clusters, "bucket_cap": index.bucket_cap, "probes": FF_IVF_PROBES,
                    "build_ms": build_ms, "search_wall_ms": wall, "search_device_ms": dev_ms,
                    "search_device_gapless": gapless, "recall_vs_exact": recall, "planted_recall": planted,
                    "matched": int(ok.sum()),
                    "invalid_rows_matched": int((~valid[ti[ok]]).sum() + (~valid[t_ti[t_ok]]).sum()),
                    "index_equals_cpu": same_index, "search_equals_cpu": same_search}))
    if recall < FF_IVF_RECALL_MIN:
        raise AssertionError(f"IVF: recall {recall} against the exact match, below {FF_IVF_RECALL_MIN}")
    if not valid[ti[ok]].all() or not valid[t_ti[t_ok]].all():
        raise AssertionError("IVF: an invalid row was matched")
    if not (same_index and same_search):
        raise AssertionError(f"IVF: card index equals the CPU's {same_index}, search {same_search}")


def run_feature_families(torch, np, dev, counters, card):
    """The feature-family phase: (a) the detectors card against CPU, (b) the
    IVF index, (c) the host facade per family over the deploy world's first
    FAMILY_FRAMES frames at its RANSAC seeds; a family that the JAX package
    fails at every seed there (FF_JAX) runs tests/test_float_family_slam.py's
    world and ``sift_config`` instead, with that test's assertions as gates.
    Prints one JSON line per part and run; returns the K1-K4 launches of
    parts a and c; raises if a gate fails."""
    import facade_world as fw

    from visual_slam_tpu_torch.config import Config

    t_phase = time.perf_counter()
    deploy = fw.deploy_frames(fw.FAMILY_FRAMES)
    total = [ff_detectors(torch, np, dev, deploy[0][0], counters[0]), 0, 0, 0]
    ff_ivf(torch, np, dev)
    for family, (detector, matcher, _, seeds) in fw.FAMILIES.items():
        ref = FF_JAX[family]
        e2e = ref["failed"] == len(seeds)
        frames, K, Ts = fw.e2e_frames(10) if e2e else deploy
        runs = []
        for seed in seeds:
            cfg = fw.sift_config(Config, family) if e2e else fw.family_config(Config, family)
            slam, r = facade_run(torch, np, dev, counters, frames, K, Ts, cfg, ransac_seed=seed)
            widths = sorted({int(np.asarray(mp.descriptor).size) for mp in slam.map.get_map_points()
                             if mp.descriptor is not None})
            words = slam.feature_tracker.desc_words
            kf_pct = r.get("ate_keyframes", {}).get("pct", float("inf"))
            if e2e:  # tests/test_float_family_slam.py's assertions
                ok = (r["last_states"] == ["OK", "OK"] and r["keyframes"] >= 3 and r["landmarks"] > 50
                      and widths == [words])
                outcome = "clean" if ok else "failed the e2e assertions"
            else:
                outcome = "LOST" if r["lost_after_boot"] else "scale jump" if kf_pct > FACADE_JUMP_PCT else "clean"
            r.update(family=family, world="e2e" if e2e else "deploy", detector=detector, matcher=matcher,
                     desc_widths=widths, card=card, outcome=outcome)
            log(json.dumps({"phase": "feature_families_facade", **r}, default=float))
            for k, n in enumerate(r["launches"]):
                total[k] += n
            if words == 8:
                expected = [r["detects"], r["matches"], r["guided"], 0]
                if r["launches"] != expected:
                    raise AssertionError(f"{family}: launches K1-K4 {r['launches']} != the run's calls {expected}")
            elif any(r["launches"]) or widths != [128]:
                raise AssertionError(f"{family}: launches K1-K4 {r['launches']}, landmark descriptor widths {widths}")
            runs.append(r)
            del slam
        clean = [r["ate_keyframes"]["pct"] for r in runs if r["outcome"] == "clean"]
        failed = [(r["ransac_seed"], r["outcome"]) for r in runs if r["outcome"] != "clean"]
        med = statistics.median(clean) if clean else None
        gate = max(2 * ref["median_pct"], FF_ATE_PCT_FLOOR) if ref["median_pct"] is not None else None
        log(json.dumps({"phase": "feature_families_runs", "family": family, "world": "e2e" if e2e else "deploy",
                        "seeds": list(seeds), "outcomes": [r["outcome"] for r in runs], "failed_runs": failed,
                        "jax_failed": ref["failed"], "median_clean_ate_keyframes_pct": med, "ate_gate_pct": gate,
                        "fps_after_boot": [r["fps_after_boot"] for r in runs], "card": card}))
        if e2e and failed:
            raise AssertionError(f"{family}: runs on the e2e world failed its assertions {failed}")
        if not e2e and len(failed) > ref["failed"]:
            raise AssertionError(f"{family}: {len(failed)} failed runs {failed}, JAX fails {ref['failed']}")
        if not e2e and med is not None and med > gate:
            raise AssertionError(f"{family}: median keyframe ATE {med:.3f} % above {gate:.3f} %")
    log(f"feature families phase: {time.perf_counter() - t_phase:.1f} s, launches K1-K4 {total}")
    return total


def run_processing(torch, np, dev, counters, source, K, cfg, p1_tx=None, on_frame=None):
    """``Processing`` over ``source`` with a KITTI ``calib.txt`` holding K as
    P0 and, for stereo, P1 with ``p1_tx`` (-baseline x fx) as its fourth
    entry; ``on_frame(i, info)`` goes to ``run()``. Returns (run()'s result,
    (state, T_w2c or None) per frame, the ``SLAM``); the counters are zeroed
    first."""
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
    out = proc.run(on_frame=on_frame)
    torch.cuda.synchronize()
    return out, states, slam


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


def run_small_ring(torch, np, dev, counters):
    """The small ring (test_compiled_slam_devpromo_loop_closing's world)
    through ``CompiledSLAM`` on the card with a checkpoint after
    SR_CHECKPOINT, then a new system resumed from it (the id counters reset
    as in a new process) over the frames after it. Returns (the pass's
    report, the resumed pass's, the restored keyframe and landmark
    counts)."""
    import shutil
    import tempfile

    import loop_pipeline_world as lpw

    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.map import KeyFrame
    from visual_slam_tpu_torch.map.frame import FrameBase
    from visual_slam_tpu_torch.models import CompiledSLAM

    frames, K, T_gt = lpw.small_ring_frames()
    h, w = frames[0].shape
    cam = PinholeCamera(width=w, height=h, K=K)
    ckpt = Path(tempfile.mkdtemp(prefix="small_ckpt_"))
    try:
        small = loop_pass(torch, np, CompiledSLAM(cam, lpw.small_ring_config(Config), device=dev), frames, T_gt,
                          counters, "small", save=(SR_CHECKPOINT, ckpt))
        with FrameBase._ids_lock:
            FrameBase._ids = itertools.count(0)
        with KeyFrame._kf_ids_lock:
            KeyFrame._kf_ids = itertools.count(0)
        slam = CompiledSLAM.resume(ckpt, cam, device="cuda")
        restored = (slam.map.num_keyframes(), slam.map.num_map_points())
        small_res = loop_pass(torch, np, slam, frames, T_gt, counters, "small_resume", start=SR_CHECKPOINT + 1)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return small, small_res, restored


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
        off = loop_pass(torch, np, CompiledSLAM(cam, lpw.loop_config(Config, False), device=dev), frames[:LP_SHORT],
                        T_gt[:LP_SHORT], counters, "off", warm_end=lambda i: lpw.warm_end(i, LP_SHORT))
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
    small = small_res = None
    if LP_JAX["on_closures"] == 0:
        small, small_res, small_restored = run_small_ring(torch, np, dev, counters)
        total = [a + b + c for a, b, c in zip(total, small["launches_k1_k5"], small_res["launches_k1_k5"])]
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
        n = len(frames) if mode == "async" else LP_SHORT
        modes[mode] = loop_pass(torch, np, slam, frames[:n], T_gt[:n], counters, mode,
                                warm_end=lambda i: lpw.warm_end(i, n))
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
    # A closure after resuming, on each ring whose uninterrupted pass closed
    # after its checkpoint; at least one ring must be held to it.
    resumed = [(on, res, LP_CHECKPOINT)] + ([] if small is None else [(small, small_res, SR_CHECKPOINT)])
    held = [(a, b) for a, b, ck in resumed if any(c["frame"] > ck for c in a["closures"])]
    for a, b in held:
        if not b["closures"]:
            fails.append(f"{b['run']}: no closure after resuming, where the uninterrupted pass closed after the "
                         f"checkpoint")
    if not held:
        fails.append("resume: neither uninterrupted pass closed after its checkpoint, so no resumed pass is held to "
                     "a closure")
    if small_res is not None:
        # No ATE bound: the restored poses keep their saved values while the
        # closure after resuming moves the map, so the whole trajectory's ATE
        # is not the uninterrupted pass's.
        if small_res["lost"] or small_res["state"] != "OK":
            fails.append(f"small_resume: {small_res['lost']} LOST frames, state {small_res['state']}")
        if small_restored != (small["saved_keyframes"], small["saved_landmarks"]):
            fails.append(f"small_resume: restored {small_restored}, saved "
                         f"{(small['saved_keyframes'], small['saved_landmarks'])}")
    log(f"loop pipeline: ATE on {on['ate_pct_of_path']:.3f} % (gate {on_max:.3f}), off {off['ate_pct_of_path']:.3f} % "
        f"(gate {off_max:.3f}), resumed {res['ate_pct_of_path']:.3f} % (gate {res_max:.3f}); FPS on {on['fps']:.2f}, "
        f"off {off['fps']:.2f}, resumed {res['fps']:.2f}; closures on {len(on['closures'])}, resumed "
        f"{len(res['closures'])}, small ring {None if small is None else len(small['closures'])}, small ring resumed "
        f"after frame {SR_CHECKPOINT} {None if small_res is None else len(small_res['closures'])}; launches K1-K5 "
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


def adam_alone(torch, np, dev, card) -> dict:
    """Part a of the adam phase: ``adam_bundle_adjust`` on bench.py's BA
    problem on the card (wall per synchronised call, device ms by events,
    host syncs inside one solve, cost0 and cost) against its CPU run, and
    the LM's ``bundle_adjust`` beside it on the same problem."""
    import ba_world

    from visual_slam_tpu_torch.backend.adam import adam_bundle_adjust
    from visual_slam_tpu_torch.backend.ba import BAProblem, bundle_adjust
    from visual_slam_tpu_torch.utils.tree import to_device

    cpu = to_device(BAProblem(**ba_world.bench_problem()), "cpu")
    gpu = to_device(cpu, dev)
    huber = 5.0 / FOCAL
    adam = lambda n=ADAM_ITERS: adam_bundle_adjust(gpu, n_iter=n, lr=ADAM_LR, huber=huber)  # noqa: E731
    lm = lambda: bundle_adjust(gpu, n_iter=ADAM_LM_ITERS, huber=huber)  # noqa: E731
    row = dict(phase="adam_alone", W=cpu.n_poses, M=cpu.n_points, n_obs=int(cpu.obs_valid.sum()), card=card)
    for name, fn, profiled, steps in (("adam", adam, lambda: adam(ADAM_PROFILE_ITERS), ADAM_PROFILE_ITERS),
                                      ("lm", lm, lm, 1)):
        torch.cuda.synchronize()
        with count_syncs(torch) as syncs:
            T, X, info = fn()
        torch.cuda.synchronize()
        med, mn = timed(fn, reps=ADAM_REPS, warmup=0)
        dms, gapless = device_ms(fn, n=1, warmup=0)
        prof = profile_calls(torch, profiled, 1)
        scale = (ADAM_ITERS if name == "adam" else 1) / steps  # the profiled steps to one solve
        row.update({f"{name}_ms": med, f"{name}_ms_min": mn, f"{name}_device_ms": dms,
                    f"{name}_device_gapless": gapless, f"{name}_busy_ms": prof["busy_ms_per_call"] * scale,
                    f"{name}_kernels": prof["kernels_per_call"] * scale, f"{name}_syncs": sum(syncs.values()),
                    f"{name}_cost0": float(info["cost0"]), f"{name}_cost": float(info["cost"])})
        if name == "adam":
            T_g, X_g, i_g = T, X, info
    T_c, X_c, i_c = adam_bundle_adjust(cpu, n_iter=ADAM_ITERS, lr=ADAM_LR, huber=huber)
    costs_g, costs_c = i_g["costs"].cpu().numpy(), i_c["costs"].numpy()
    row.update(cpu_cost=float(i_c["cost"]), cost0_rel_diff=abs(row["adam_cost0"] / float(i_c["cost0"]) - 1.0),
               costs_max_rel_diff=float(np.max(np.abs(costs_g - costs_c) / np.abs(costs_c))),
               T_max_abs_diff=float((T_g.cpu() - T_c).abs().max()), X_max_abs_diff=float((X_g.cpu() - X_c).abs().max()))
    log(json.dumps(row))
    log(f"adam alone W={row['W']} M={row['M']} ({row['n_obs']} observations), {ADAM_ITERS} steps: "
        f"{row['adam_ms']:.2f} ms (device {row['adam_device_ms']:.2f}), cost {row['adam_cost0']:.6g} -> "
        f"{row['adam_cost']:.6g}, syncs {row['adam_syncs']}, {row['adam_kernels']:.0f} kernels busy "
        f"{row['adam_busy_ms']:.2f} ms under the profiler ({ADAM_PROFILE_ITERS} steps scaled to {ADAM_ITERS}); LM {ADAM_LM_ITERS} iterations {row['lm_ms']:.2f} ms "
        f"(device {row['lm_device_ms']:.2f}, {row['lm_kernels']:.0f} kernels busy {row['lm_busy_ms']:.2f} ms), cost "
        f"{row['lm_cost']:.6g}; card against CPU: cost curve "
        f"{row['costs_max_rel_diff']:.2e}, T {row['T_max_abs_diff']:.2e}, X {row['X_max_abs_diff']:.2e} ({card})")
    fails = []
    if not row["adam_cost"] < 0.5 * row["adam_cost0"]:
        fails.append(f"cost {row['adam_cost']} not below half of cost0 {row['adam_cost0']}")
    if row["adam_syncs"]:
        fails.append(f"{row['adam_syncs']} host syncs inside the solve")
    if (row["cost0_rel_diff"] > ba_world.ADAM_COST0_RTOL or row["costs_max_rel_diff"] > ba_world.ADAM_COSTS_RTOL
            or row["T_max_abs_diff"] > ba_world.ADAM_T_ATOL or row["X_max_abs_diff"] > ba_world.ADAM_X_ATOL):
        fails.append("the card's solve is off the CPU's")
    if fails:
        raise AssertionError("adam alone: " + "; ".join(fails))
    return row


def adam_facade(torch, np, dev, counters, card) -> list[int]:
    """Part b of the adam phase: ``SLAM`` with ``solver="adam"`` over the
    deploy world's first ADAM_FRAMES frames (classed and printed beside the
    JAX package's run), then over the e2e sprite world with
    tests/test_torch_adam.py's assertions; counted as the facade phases are.
    Returns the K1-K4 launches of both runs."""
    import facade_world as fw

    from visual_slam_tpu_torch.backend.adam import AdamOptimizer
    from visual_slam_tpu_torch.config import Config

    solves = collections.Counter()
    wrapped = AdamOptimizer._solve_and_writeback

    def count(self, *a, **kw):
        solves["adam"] += 1
        return wrapped(self, *a, **kw)

    total = [0, 0, 0, 0]
    AdamOptimizer._solve_and_writeback = count
    try:
        for world in ("deploy", "e2e"):
            frames, K, Ts = fw.deploy_frames(ADAM_FRAMES) if world == "deploy" else fw.e2e_frames(ADAM_E2E_FRAMES)
            cfg = fw.deploy_config(Config) if world == "deploy" else fw.e2e_config(Config)
            cfg.optimization.solver = "adam"
            solves.clear()
            slam, r = facade_run(torch, np, dev, counters, frames, K, Ts, cfg)
            kf = r.get("ate_keyframes", {})
            r.update(world=world, solver=type(slam.optimizer).__name__, adam_solves=solves["adam"], card=card,
                     finite_poses=all(bool(np.isfinite(k.T_w2c).all()) for k in slam.map.get_keyframes()))
            if world == "deploy":
                pct = kf.get("pct", float("inf"))
                r["outcome"] = "LOST" if r["lost_after_boot"] else "scale jump" if pct > FACADE_JUMP_PCT else "clean"
                r["jax_ate_keyframes_pct"] = ADAM_JAX_DEPLOY_ATE_PCT
            else:
                r["ate_gate_m"] = min(max(1.5 * ADAM_E2E_JAX_ATE_M, ADAM_E2E_JAX_ATE_M + 0.1), 0.5)
            log(json.dumps({"phase": "adam_facade", **{k: v for k, v in r.items() if k != "funnel"}}, default=float))
            check_facade_launches(f"adam facade, {world}", r, len(frames) - r["boot_frame"] - 1 - r["lost_after_boot"])
            for k, n in enumerate(r["launches"]):
                total[k] += n
            if r["solver"] != "AdamOptimizer" or not solves["adam"] or not r["finite_poses"]:
                raise AssertionError(f"adam facade, {world}: optimizer {r['solver']}, {solves['adam']} Adam solves, "
                                     f"finite poses {r['finite_poses']}")
            if world == "e2e" and (r["state"] != "OK" or r["lost_after_boot"] or r["keyframes"] < 3
                                   or not kf.get("m", float("inf")) <= r["ate_gate_m"]):
                raise AssertionError(f"adam facade, e2e: state {r['state']}, {r['lost_after_boot']} LOST frames, "
                                     f"{r['keyframes']} keyframes, keyframe ATE {kf.get('m')} m (gate "
                                     f"{r['ate_gate_m']:.4f})")
            del slam
    finally:
        AdamOptimizer._solve_and_writeback = wrapped
    return total


def k2_wide(torch, np, dev, card) -> dict:
    """Part c of the adam phase: K2 and K4 at train blocks past 5800 rows
    exact against their plain versions, and FlannMatcher's exact route at
    FLANN_EXACT_ROWS binary train rows, the card against the CPU. Launches
    here compare a kernel with its plain version and are not counted."""
    from visual_slam_tpu_torch.frontend.matcher import FlannMatcher
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.detector import Features

    rng = np.random.default_rng(20)
    out = {"phase": "k2_wide", "card": card}
    saved = (mk.hamming_top2.launches, mk.hamming_top2_batched.launches)
    for n2 in K2_WIDE_ROWS:
        d1, d2, v1, v2 = hamming_fixture(np, rng, 2000)
        d2 = np.concatenate([d2, rng.integers(0, 2**32, (n2 - 2000, 8), dtype=np.uint64).astype(np.uint32)])
        v2 = np.concatenate([v2, rng.random(n2 - 2000) > 0.05])
        d2[n2 - 1] = d2[1]  # a tie of column 1 in the last tile: argbest stays 1, second == best
        d2[n2 - 2] = d1[3]  # query 3's exact match in the last tile
        v1[3] = v2[1] = v2[n2 - 2] = v2[n2 - 1] = True
        args = [torch.from_numpy(a).to(dev) for a in (d1.view(np.int32), d2.view(np.int32), v1, v2)]
        for name, fn, ref, a in (
                ("K2", mk.hamming_top2, mk.hamming_top2_ref, args),
                ("K4", mk.hamming_top2_batched, mk.hamming_top2_batched_ref,
                 [args[0], args[1][None].repeat(K4_WIDE_C, 1, 1), args[2],
                  torch.stack([args[3].roll(c) for c in range(K4_WIDE_C)])])):
            got, want = fn(*a), ref(*a)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            out[f"{name}_2000x{n2}_exact"] = same
            if not same:
                raise AssertionError(f"{name} at 2000 x {n2}: differs from its plain version")
    for n2 in FLANN_EXACT_ROWS:
        d1, d2, v1, v2 = hamming_fixture(np, rng, 2000)
        d2 = np.concatenate([d2, rng.integers(0, 2**32, (n2 - 2000, 8), dtype=np.uint64).astype(np.uint32)])
        v2 = np.concatenate([v2, np.ones(n2 - 2000, bool)])
        res = {}
        for d in ("cpu", dev):
            f = [Features(xy=torch.zeros((len(dd), 2), device=d), response=torch.ones(len(dd), device=d),
                          angle=torch.zeros(len(dd), device=d), octave=torch.zeros(len(dd), dtype=torch.int32, device=d),
                          size=torch.full((len(dd),), 31.0, device=d), desc=torch.from_numpy(dd.view(np.int32)).to(d),
                          valid=torch.from_numpy(vv).to(d)) for dd, vv in ((d1, v1), (d2, v2))]
            res[str(d)] = FlannMatcher(ratio=0.8).match(*f)
        same = all(torch.equal(res[str(dev)][k].cpu(), res["cpu"][k]) for k in ("train_idx", "distance", "valid"))
        out[f"flann_exact_{n2}_same_as_cpu"] = same
        out[f"flann_exact_{n2}_matches"] = int(res["cpu"]["n_matches"])
        if not same:
            raise AssertionError(f"FlannMatcher's exact route at {n2} train rows: the card differs from the CPU")
    mk.hamming_top2.launches, mk.hamming_top2_batched.launches = saved
    log(json.dumps(out))
    return out


def run_adam(torch, np, dev, counters, card) -> list[int]:
    """The adam phase: (a) the Adam solver alone against the LM, (b) the
    facade with ``solver="adam"``, (c) K2 and K4 past 5800 train rows.
    Returns the K1-K4 launches of part b."""
    t = [time.perf_counter()]
    adam_alone(torch, np, dev, card)
    t.append(time.perf_counter())
    launches = adam_facade(torch, np, dev, counters, card)
    t.append(time.perf_counter())
    k2_wide(torch, np, dev, card)
    t.append(time.perf_counter())
    log(f"adam phase: {t[3] - t[0]:.1f} s (a {t[1] - t[0]:.1f}, b {t[2] - t[1]:.1f}, c {t[3] - t[2]:.1f}), facade "
        f"launches K1-K4 {launches}")
    return launches


def _example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_dataset(torch, np, dev, counters, card) -> list[int]:
    """Phase 12 (the module docstring's item 12): the deploy world's PNG
    files through the native loader and from memory, the exports, the 320x240
    PNG world's state and ATE gates, the demo traced, and one LM solve's
    FLOPs. Returns the phase's K1-K5 launches."""
    import contextlib
    import tempfile

    import ba_world
    import dataset_world as dsw
    import facade_world as fw

    from visual_slam_tpu_torch.backend.ba import BAProblem, bundle_adjust
    from visual_slam_tpu_torch.io import native
    from visual_slam_tpu_torch.io.source import DataSourceBase
    from visual_slam_tpu_torch.utils import profiling
    from visual_slam_tpu_torch.utils.metrics import ate_rmse
    from visual_slam_tpu_torch.utils.serialization import load_map, load_trajectory_tum
    from visual_slam_tpu_torch.utils.tree import to_device

    t_phase = time.perf_counter()
    total = [0] * len(counters)

    def launches() -> list[int]:
        now = [fn.launches for fn in counters]
        for k, n in enumerate(now):
            total[k] += n
        return now

    rd, demo = _example("run_dataset_torch"), _example("visual_odometry_demo_torch")
    fails = []
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        d = Path(d)
        t0 = time.perf_counter()
        images, calib, u8, K, Ts = dsw.deploy_dataset(d / "seq", RD_FRAMES)
        write_s = time.perf_counter() - t0
        png_bytes = sum(p.stat().st_size for p in images.iterdir())
        t0 = time.perf_counter()
        native._compile(force=True)
        native.get_lib()
        build_s = time.perf_counter() - t0

        # The loader against the written arrays, exactly.
        fps = rd.make_config(rd.parse_args([str(images)])).camera.fps
        paths = sorted(images.glob("*.png"))
        decode_bad = [i for i, path in enumerate(paths) if not np.array_equal(native.decode_image(path), u8[i])]
        src = native.NativeDatasetSource(images, fps=fps)
        source_bad = []
        for i in range(RD_FRAMES):
            f, ts = src.get_frame()
            if f is None or f.dtype != np.float32 or not np.array_equal(f, u8[i].astype(np.float32)) or ts != i / fps:
                source_bad.append(i)
        loader_errors = src.decode_errors()
        src.release()
        log(json.dumps({"phase": "dataset_loader", "frames": len(paths), "shape": list(u8.shape[1:]),
                        "png_bytes": png_bytes, "write_s": write_s, "build_s": build_s,
                        "lib": str(native._LIB.relative_to(ROOT)), "decode_mismatches": decode_bad,
                        "source_mismatches": source_bad, "decode_errors": loader_errors}))
        if decode_bad or source_bad or loader_errors:
            raise AssertionError(f"native loader: decode mismatches {decode_bad}, source mismatches {source_bad}, "
                                 f"decode errors {loader_errors}")

        # examples/run_dataset_torch.py through the native loader, on the card.
        argv = [str(images), str(calib), *RD_ARGS, "--out-dir", str(d / "out")]
        for fn in counters:
            fn.launches = 0
        gc.collect()
        png = rd.main(argv)
        torch.cuda.synchronize()
        png_launches = launches()

        # The same uint8 frames from memory, with the loader's timestamps.
        class Memory(DataSourceBase):
            def __init__(self):
                self.i = 0

            def get_frame(self):
                self.i += 1
                return u8[self.i - 1], (self.i - 1) / fps

            def is_ok(self):
                return self.i < RD_FRAMES

            def get_frame_shape(self):
                return u8.shape[1:]

        done_at = []
        mem, mem_states, mem_slam = run_processing(torch, np, dev, counters, Memory(), K,
                                                   rd.make_config(rd.parse_args(argv)),
                                                   on_frame=lambda i, info: done_at.append(time.perf_counter()))
        mem_launches = launches()
        mem_states = [st for st, _ in mem_states]
        mem_boot = next((i for i, st in enumerate(mem_states) if st == "OK"), RD_FRAMES)
        mem_fps = (RD_FRAMES - mem_boot - 1) / (done_at[-1] - done_at[mem_boot]) if mem_boot < RD_FRAMES - 1 else 0.0

        kf_png, kf_mem = png["slam"].map.get_keyframes(), mem_slam.map.get_keyframes()
        c_png = np.stack([kf.camera_center for kf in kf_png])
        pose_diff = (float(np.abs(c_png - np.stack([kf.camera_center for kf in kf_mem])).max())
                     if len(kf_png) == len(kf_mem) else float("inf"))
        ate = fw.ate(ate_rmse, [kf.timestamp for kf in kf_png], [kf.T_w2c for kf in kf_png], Ts, dt=1.0 / fps)
        lost = png["states"][png["boot_frame"]:].count("LOST")
        outcome = ("LOST" if lost or png["state"] != "OK" else "scale jump" if ate["pct"] > FACADE_JUMP_PCT
                   else "clean")

        # The exports, loaded back.
        ex = png["exports"]
        T_c2w = np.linalg.inv(np.stack([kf.T_w2c for kf in kf_png]))
        _, tum_T = load_trajectory_tum(ex["trajectory_tum.txt"])
        kitti = np.loadtxt(ex["trajectory_kitti.txt"]).reshape(-1, 3, 4)
        tum_err = float(np.abs(tum_T - T_c2w).max()) if tum_T.shape == T_c2w.shape else float("inf")
        kitti_err = float(np.abs(kitti - T_c2w[:, :3]).max()) if len(kitti) == len(T_c2w) else float("inf")
        loaded = load_map(ex["map.npz"], device=dev)
        lkfs = loaded.get_keyframes()
        npz_ok = (len(lkfs) == len(kf_png) and all(np.array_equal(a.T_w2c, b.T_w2c) for a, b in zip(lkfs, kf_png))
                  and all(kf.features[0].xy.device.type == "cuda" for kf in lkfs))
        good = sum(not mp.is_bad for mp in png["slam"].map.get_map_points())
        ply = ex["map.ply"].read_text().splitlines()
        ply_vertices = int(ply[2].split()[-1])
        row = {"phase": "run_dataset", "card": card, "frames": png["frames"], "state": png["state"],
               "memory_state": mem["state"], "boot_frame": png["boot_frame"], "memory_boot_frame": mem_boot,
               "lost": lost, "memory_lost": mem_states.count("LOST"),
               "decode_errors": png["decode_errors"], "keyframes": png["keyframes"],
               "memory_keyframes": mem["keyframes"], "map_points": png["map_points"],
               "memory_map_points": mem["map_points"], "keyframe_centre_max_diff_m": pose_diff,
               "ate_keyframes": ate, "outcome": outcome, "jax": RD_JAX, "fps_after_boot_png": png["fps_after_boot"],
               "fps_after_boot_memory": mem_fps, "tum_max_err": tum_err, "kitti_max_err": kitti_err,
               "map_npz_on_card": npz_ok, "ply_vertices": ply_vertices, "good_landmarks": good,
               "launches_png": png_launches, "launches_memory": mem_launches}
        log(json.dumps(row, default=float))
        log(f"run_dataset, {RD_FRAMES} PNG frames {list(u8.shape[1:])}: FPS after the bootstrap {png['fps_after_boot']:.2f} "
            f"from PNG, {mem_fps:.2f} from memory ({card}); {outcome}, keyframe ATE {ate['pct']:.4f} % (JAX's CPU "
            f"run {RD_JAX['ate_pct']:.4f} %); native against memory keyframe centres {pose_diff:.3g} m")
        if png["states"] != mem_states or png["state"] != mem["state"]:
            fails.append(f"states: PNG {png['state']} {png['states']}, memory {mem['state']} {mem_states}")
        if png["decode_errors"]:
            fails.append(f"{png['decode_errors']} decode errors")
        if not pose_diff <= RD_POSE_ATOL:
            fails.append(f"native and in-memory keyframe centres {pose_diff} m apart ({len(kf_png)} and "
                         f"{len(kf_mem)} keyframes)")
        if not (tum_err <= RD_EXPORT_ATOL and kitti_err <= RD_EXPORT_ATOL and npz_ok and ply_vertices == good
                and len(ply) == 10 + good):
            fails.append(f"exports: TUM {tum_err}, KITTI {kitti_err}, map.npz {npz_ok}, PLY {ply_vertices} vertices "
                         f"against {good} landmarks")
        for name, n in (("PNG", png_launches), ("memory", mem_launches)):
            if n[0] < RD_FRAMES or not n[1] or not n[2]:
                fails.append(f"{name} run launched K1-K3 {n[:3]} times over {RD_FRAMES} frames")
        del png, mem_slam, loaded
        gc.collect()

        # The small world: its state and ATE gates.
        s_images, s_calib, _, _, s_Ts = dsw.small_dataset(d / "small")
        for fn in counters:
            fn.launches = 0
        small = rd.main([str(s_images), str(s_calib), "--native-loader", *dsw.SMALL_ARGS, "--out-dir", str(d / "small_out")])
        torch.cuda.synchronize()
        small_launches = launches()
        kfs = small["slam"].map.get_keyframes()
        s_ate = fw.ate(ate_rmse, [kf.timestamp for kf in kfs], [kf.T_w2c for kf in kfs], s_Ts, dt=1.0 / fps)
        s_gate = max(2 * RD_SMALL_JAX["ate_pct"], RD_ATE_PCT_FLOOR)
        s_lost = small["states"].count("LOST")
        log(json.dumps({"phase": "run_dataset_small", "card": card, "frames": small["frames"], "state": small["state"],
                        "boot_frame": small["boot_frame"], "lost": s_lost, "decode_errors": small["decode_errors"],
                        "keyframes": small["keyframes"], "map_points": small["map_points"], "ate_keyframes": s_ate,
                        "ate_gate_pct": s_gate, "jax": RD_SMALL_JAX, "fps_after_boot": small["fps_after_boot"],
                        "launches": small_launches}, default=float))
        if small["state"] != "OK" or s_lost or small["keyframes"] < 2 or small["decode_errors"]:
            fails.append(f"small world: {small['state']}, {s_lost} LOST, {small['keyframes']} keyframes, "
                         f"{small['decode_errors']} decode errors")
        if not s_ate["pct"] <= s_gate:
            fails.append(f"small world: keyframe ATE {s_ate['pct']:.4f} % above {s_gate:.4f} %")
        if small_launches[0] < len(small["states"]) or not small_launches[1] or not small_launches[2]:
            fails.append(f"small world launched K1-K3 {small_launches[:3]} times over {len(small['states'])} frames")
        del small
        gc.collect()

        # The demo, with torch.profiler around two of its frames.
        for fn in counters:
            fn.launches = 0
        trace_dir, tracing = d / "trace", contextlib.ExitStack()
        trace = {"open": False, "frames": 0, "start": None}

        def on_frame(i, slam):
            now = [fn.launches for fn in counters[:3]]
            if i == RD_TRACE_AFTER:
                torch.cuda.synchronize()
                tracing.enter_context(profiling.device_trace(trace_dir))
                trace.update(open=True, start=now)
            elif trace["open"]:
                trace["frames"] += 1
                if trace["frames"] >= 2 and all(a > b for a, b in zip(now, trace["start"])):
                    torch.cuda.synchronize()
                    tracing.close()
                    trace["open"] = False

        with tracing:
            demo_out = demo.main([], on_frame=on_frame)
        torch.cuda.synchronize()
        demo_launches = launches()
        n_traced = trace["frames"]
        trace_files = sorted(trace_dir.glob("*.json"))
        text = trace_files[0].read_text() if trace_files else ""
        found = {k: name in text for k, name in RD_KERNEL_NAMES.items()}
        log(json.dumps({"phase": "demo", "card": card, "ate_rmse": demo_out["ate"]["rmse"],
                        "keyframes": demo_out["keyframes"], "landmarks": demo_out["landmarks"],
                        "last_state": demo_out["states"][-1], "timing": demo_out["timing"],
                        "launches": demo_launches, "traced_frames": n_traced, "trace_bytes": len(text),
                        "kernels_in_trace": found}, default=float))
        if not all(found.values()):
            fails.append(f"the trace of {n_traced} demo frames lacks kernels: {found}")
        if demo_out["states"][-1] != "OK" or not all(demo_launches[:3]):
            fails.append(f"demo: last state {demo_out['states'][-1]}, launches K1-K3 {demo_launches[:3]}")

    # FLOPs and MFU of one LM solve at bench's BA problem (W 10, M 4096).
    gpu = to_device(BAProblem(**ba_world.bench_problem()), dev)
    lm = lambda: bundle_adjust(gpu, n_iter=ADAM_LM_ITERS, huber=5.0 / FOCAL)  # noqa: E731
    flops = profiling.flops_of(lm)
    med, mn = timed(lm, reps=3, warmup=1)
    util = profiling.mfu(flops, med / 1e3)
    log(json.dumps({"phase": "lm_flops", "card": card, "W": gpu.n_poses, "M": gpu.n_points,
                    "iterations": ADAM_LM_ITERS, "flops_products_only": flops, "ms": med, "ms_min": mn,
                    "mfu_pct_products_only": util, "peak_flops": profiling.H100_FP32_PEAK_FLOPS}))
    log(f"LM solve W={gpu.n_poses} M={gpu.n_points}, {ADAM_LM_ITERS} iterations: {flops} FLOPs (products only), "
        f"{med:.2f} ms, MFU {util} % of the fp32 peak (products only; {card})")
    log(f"run_dataset phase: {time.perf_counter() - t_phase:.1f} s, launches K1-K5 {total}")
    if fails:
        raise AssertionError("run_dataset: " + "; ".join(fails))
    return total


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

    t_start = time.perf_counter()

    def elapsed(after: str) -> None:
        log(f"elapsed {time.perf_counter() - t_start:.1f} s after {after}")

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
    # K1, K2 and K3 at the RGB-D facade's and RGB-D pipeline's shapes: the
    # RGB-D world's first frame. The world is rendered once, for the RGB-D
    # pipeline and the RGB-D facade phases.
    from visual_slam_tpu_torch.config import Config

    t0 = time.perf_counter()
    rgbd_world = dw.rgbd_frames(RGBD_FRAMES)
    log(f"rendered the RGB-D world ({RGBD_FRAMES} frames, {rgbd_world[0][0].shape}) in "
        f"{time.perf_counter() - t0:.2f} s")
    rgbd_rows = check_rgbd_kernels(torch, np, rgbd_world[0][0], dw.rgbd_config(Config).feature.num_features)
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
    # (none may come from the small solvers' files).
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
    run_lowerings(torch, np, dev, K)
    elapsed("the DLT lowerings")

    # The batched VO step: MS_B sequences in one step, counted on its own.
    multiseq_launches = run_multiseq(torch, np, dev, render_mod)
    elapsed("the kernel checks, the tracking path and batched VO")
    # The stereo step on bench_stereo_step's world, counted on its own; then
    # the batched K1 at the batched stereo step's B = 2 x SS_B.
    ss = run_stereo_step(torch, np, dev)
    k1_b8_row = batched_k1_row(torch, np, ss["b8_frames"],
                               f"patches_and_moments_batched, B = {2 * SS_B} ({SS_B} stereo pairs)")
    k1_b8_row["launches"] = ss["k1_b8"]
    elapsed("the stereo step")

    # The pose graphs (whose first solve pays the one-time set-up of
    # torch.func and the solver), then the loop path, counted on its own.
    run_pose_graphs(torch, np, dev)
    loop_launches = run_loop_path(torch, np, step, dev, counters)
    elapsed("the pose graphs and the loop path")
    fp_launches, _ = run_full_pipeline(torch, np, dev, counters)
    # The async heavy boundary on the same deployment: measured, then again
    # with the host syncs counted over the whole run.
    for check in (False, True):
        more, _ = run_full_pipeline(torch, np, dev, counters, async_boundary=True, sync_check=check)
        fp_launches = [a + b for a, b in zip(fp_launches, more)]
    run_ba_layouts(torch, np, dev)
    elapsed("the full pipeline's three runs and the BA layouts")
    sp = run_stereo_pipeline(torch, np, dev, patches_and_moments_batched, patches_and_moments_levels, mk.hamming_top2,
                             mk.guided_top2)
    elapsed("the stereo pipeline")
    rp = run_rgbd_pipeline(torch, np, dev, card, rgbd_world, patches_and_moments_levels, patches_and_moments_batched,
                           mk.hamming_top2, mk.guided_top2)
    elapsed("the RGB-D pipeline")
    facade_launches = run_facade_phases(torch, np, dev, counters)
    elapsed("the facade")
    depth = run_depth_facade_phases(torch, np, dev, (LaunchSum(patches_and_moments_levels,
                                                               patches_and_moments_batched), *counters[1:]),
                                    rgbd_world)
    elapsed("the stereo and RGB-D facade")
    stereo, rgbd = depth["stereo"], depth["rgbd"]
    stereo_launches = [stereo["k1"], stereo["k2"], stereo["k3"], stereo["k4"], 0]
    ff_launches = run_feature_families(torch, np, dev, counters, card) + [0]
    elapsed("the feature families")
    adam_launches = run_adam(torch, np, dev, counters, card) + [0]
    elapsed("the adam phase")
    rd_launches = run_dataset(torch, np, dev, counters, card)
    elapsed("the dataset phase")
    lp_launches, lp_k4, lp_k4_args = run_loop_pipeline(torch, np, dev, counters)
    elapsed("the loop pipeline")
    ss_launches = [0, ss["k2"], ss["k3"], 0, 0]
    k1b, k1l, sp_k2, sp_k3 = sp["launches_k1_batched_k1_levels_k2_k3"]
    sp_launches = [k1l, sp_k2, sp_k3, 0, 0]
    parts = list(zip(launches, ss_launches, loop_launches, fp_launches, sp_launches, facade_launches,
                     stereo_launches, ff_launches, adam_launches, rd_launches, lp_launches))
    for row, part in zip(rows, parts):
        row["launches"] = sum(part)
    for row, n in zip(rows[len(parts):], multiseq_launches):
        row["launches"] = n
    # The stereo pairs' K1 at B = 2: the stereo facade's, the stereo step's
    # and the stereo pipeline's.
    rows[len(parts) + len(multiseq_launches)]["launches"] = stereo["k1_batched"] + ss["k1_b2"] + k1b
    # The RGB-D shapes: the facade phases' K1, K2 and K3 (its 2048-slot
    # block), the RGB-D pipeline's K1 and K2, and its K3 on the 4096-slot arena.
    rp_k1, _, rp_k2, rp_k3 = rp["launches_k1_levels_k1_batched_k2_k3"]
    for row, n in zip(rgbd_rows, (rgbd["k1"] + rp_k1, rgbd["k2"] + rp_k2, rgbd["k3"], rp_k3)):
        row["launches"] = n
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch in the RGB-D phases")
    if rgbd["k1_batched"] or rgbd["k4"]:
        raise AssertionError(f"RGB-D phases launched the batched K1 {rgbd['k1_batched']} and K4 {rgbd['k4']} times")
    rows.append(k1_b8_row)
    log("launches per kernel (tracking, stereo step, loop path, full pipeline with its two async runs, stereo "
        "pipeline, facade phases, stereo facade phases, feature families, the adam facade, the dataset phase, loop "
        "pipeline phases "
        "with the async and sparse passes): "
        f"{[(r['name'], *part) for r, part in zip(rows, parts)]}; K5 has no caller on any path; "
        f"batched (multiseq phase; stereo facade phases, the stereo step and the stereo pipeline ({k1b})), RGB-D "
        f"facade phases and RGB-D pipeline (K1 {rp_k1}, K2 {rp_k2}, K3 {rp_k3}) and the batched stereo step: "
        f"{[(r['name'], r['launches']) for r in rows[len(parts):]]}")
    # K4 at the ring's own shortlist shapes: the on pass's fullest detect.
    rows.append(k4_row(torch, lp_k4_args, "hamming_top2_batched, loop pipeline shortlist"))
    rows[-1]["launches"] = lp_k4

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if sp.get("gate_failed"):
        raise AssertionError(sp["gate_failed"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
