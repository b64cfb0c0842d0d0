#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card (nvidia-smi name and power limit) and refuses to run
   without CUDA: there is no CPU path.
2. Builds the CUDA kernels from ``visual_slam_tpu_torch/csrc``.
3. Holds each kernel (K1 patches+moments, K2 Hamming top-2, K3 guided
   top-2, K4 Hamming top-2 against 64 candidate blocks, K5 32x32 window
   gather) against its plain PyTorch version on the card, at the shapes its
   path gives it, and times both.
4. Tracking path: the fused mono tracking step with a 4096-slot local-map
   arena, 2000 features, 4 levels, 128 RANSAC hypotheses, over a rendered
   376x1240 sprite world (f = 718.856) in two chunks of 8 frames. Checks
   poses against ground truth and the kernels' launch counts, lists the host
   syncs inside one step, times single steps and chunks, and holds one frame
   against the same step run on the CPU through the plain versions.
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
7. Prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``
   as the last line. Any failure raises and exits nonzero.

K5 has no caller in either package: only phase 3 launches it.
"""
from __future__ import annotations

import collections
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
REPS = 20
# Loop path: bench.bench_loop_pipeline's deployment, keyframes only.
LOOP_FRAMES, KF_EVERY, LOOP_SPRITES = 200, 4, 2400
C_REAL, C_PAD = 8, 64  # shortlist and candidate bucket of LoopClosing.detect
PG_NODES, PG_LOOPS, PG_ITERS = 256, 8, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = REPS, warmup: int = 3) -> tuple[float, float]:
    """(median, min) milliseconds of fn(), synchronised inside the region."""
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


def make_world_frames(render_mod, np):
    """Sprite world sized like bench.synth_kitti_frames (900 sprites,
    x -30..40 m, y -8..8 m, z 8..50 m), seen along tests/render.py's
    forward-lateral path with slow yaw."""
    rng = np.random.default_rng(0)
    world = render_mod.make_world(rng, n_sprites=900, x_range=(-30, 40), y_range=(-8, 8), z_range=(8, 50))
    Ts = render_mod.camera_path(1 + CHUNK * N_CHUNKS, step=0.25)
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]], np.float32)
    frames = np.stack([render_mod.render(world, T, K, W, H) for T in Ts]).astype(np.float32)
    _, zbuf = render_mod.render_with_depth(world, Ts[0], K, W, H)
    return K, Ts, frames, zbuf


def check_kernels(torch, np, frame, K):
    """Each kernel against its plain version on the card, at main-path
    shapes; returns the rows of the kernels JSON (launches filled later)."""
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops import orb, pyramid
    from visual_slam_tpu_torch.ops.detector import detect_level, level_quotas
    from visual_slam_tpu_torch.ops.patch_kernels import (
        extract_patches32,
        extract_patches32_ref,
        patches_and_moments,
        patches_and_moments_ref,
    )

    dev = torch.device("cuda")
    rows = []

    # K1 on the four levels of a rendered frame, K_l = 643/537/447/373.
    img = torch.from_numpy(frame).to(dev)
    w = torch.from_numpy(orb.MOMENT_W_NP).to(dev)
    calls = []
    for lvl, k in zip(pyramid.build_pyramid(img, N_LEVELS, 1.2), level_quotas(N_FEATURES, N_LEVELS, 1.2)):
        yx = detect_level(lvl, k, 20.0, GRID, 16)[0]
        calls.append((lvl.contiguous(), pyramid.gaussian_blur(lvl), yx))
    err = 0.0
    for lvl, blur, yx in calls:
        mom, pat = patches_and_moments(lvl, blur, yx, w)
        mom_r, pat_r = patches_and_moments_ref(lvl, blur, yx, w)
        torch.cuda.synchronize()
        if not torch.equal(pat, pat_r):
            raise AssertionError("K1: patches differ from the plain version")
        scale = orb.extract_patches(lvl, yx).reshape(yx.shape[0], -1).abs().double() @ w.abs().double()
        diff = (mom - mom_r).abs().double()
        if not bool((diff <= MOMENT_RTOL * scale).all()):
            raise AssertionError(f"K1: moments off by {float(diff.max())} (tolerance {MOMENT_RTOL} of sum |w*p|)")
        err = max(err, float(diff.max()))
    log(f"K1 levels {[tuple(c[0].shape) for c in calls]} keypoints {[int(c[2].shape[0]) for c in calls]}: "
        f"patches exact, moments max abs err {err}")
    ms = timed(lambda: [patches_and_moments(*c, w) for c in calls])
    plain = timed(lambda: [patches_and_moments_ref(*c, w) for c in calls])
    rows.append(dict(name="patches_and_moments", route="cuda", source="visual_slam_tpu_torch/csrc/patches_moments.cu",
                     replaces="visual_slam_tpu/ops/pallas_patches.py:144", max_abs_err=err, ms=ms[0], plain_ms=plain[0]))
    log(f"K1 per frame (4 levels): kernel median {ms[0]:.4f} ms min {ms[1]:.4f}; plain median {plain[0]:.4f} ms min {plain[1]:.4f}")

    # K2 at 2000 x 2000 with planted ties and 10% invalid rows.
    rng = np.random.default_rng(1)
    n = N_FEATURES
    d2 = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    near, ties = 2 * n // 5, n // 20  # 800 near matches and blocks of 100 ties at n = 2000
    d1[:near] = d2[:near] ^ (rng.random((near, 8)) < 0.05).astype(np.uint32)
    d1[near:near + ties] = d1[:ties]  # query ties (column argmin)
    d2[n // 2:n // 2 + ties] = d2[:ties]  # train ties (argbest and second == best)
    v1 = rng.random(n) > 0.1
    v2 = rng.random(n) > 0.05
    args = [torch.from_numpy(d1.view(np.int32)).to(dev), torch.from_numpy(d2.view(np.int32)).to(dev),
            torch.from_numpy(v1).to(dev), torch.from_numpy(v2).to(dev)]
    out = mk.hamming_top2(*args)
    ref = mk.hamming_top2_ref(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("best", "second", "argbest", "col_argmin"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"K2: {name} differs from the plain version")
    log(f"K2 {n}x{n}: exact ({int(torch.from_numpy(v1).sum())} valid queries)")
    ms = timed(lambda: mk.hamming_top2(*args))
    plain = timed(lambda: mk.hamming_top2_ref(*args))
    rows.append(dict(name="hamming_top2", route="cuda", source="visual_slam_tpu_torch/csrc/hamming_top2.cu",
                     replaces="visual_slam_tpu/ops/pallas_kernels.py:99", max_abs_err=0.0, ms=ms[0], plain_ms=plain[0]))
    log(f"K2: kernel median {ms[0]:.4f} ms min {ms[1]:.4f}; plain median {plain[0]:.4f} ms min {plain[1]:.4f}")

    # K3 at 4096 landmarks x 2000 keypoints, matches planted inside the radius.
    M = ARENA
    lm_uv = np.stack([rng.uniform(0, W, M), rng.uniform(0, H, M)], 1).astype(np.float32)
    lm_desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    lm_desc[1:M // 10:2] = lm_desc[0:M // 10 - 1:2]  # landmark ties
    kp_xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1).astype(np.float32)
    kp_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    for j in range(0, 2 * n, 2):
        kp_desc[j // 2] = lm_desc[j] ^ (rng.random(8) < 0.04).astype(np.uint32)
        kp_xy[j // 2] = lm_uv[j] + rng.uniform(-20, 20, 2)
    lm_ok = rng.random(M) > 0.2
    kp_valid = rng.random(n) > 0.05
    args = [torch.from_numpy(lm_desc.view(np.int32)).to(dev), torch.from_numpy(lm_ok).to(dev),
            torch.from_numpy(lm_uv).to(dev), torch.from_numpy(kp_desc.view(np.int32)).to(dev),
            torch.from_numpy(kp_valid).to(dev), torch.from_numpy(kp_xy).to(dev),
            torch.tensor(25.0 * 25.0, device=dev)]
    lm_idx, valid = mk.guided_top2(*args)
    r_idx, r_valid = mk.guided_top2_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(valid, r_valid) and torch.equal(lm_idx, r_idx)):
        raise AssertionError("K3: lm_idx/valid differ from the plain version")
    if int(r_valid.sum()) < n // 10:
        raise AssertionError(f"K3 fixture matched only {int(r_valid.sum())} keypoints")
    log(f"K3 {M}x{n}: exact ({int(r_valid.sum())} keypoints matched)")
    ms = timed(lambda: mk.guided_top2(*args))
    plain = timed(lambda: mk.guided_top2_ref(*args))
    rows.append(dict(name="guided_top2", route="cuda", source="visual_slam_tpu_torch/csrc/guided_top2.cu",
                     replaces="visual_slam_tpu/ops/pallas_kernels.py:250", max_abs_err=0.0, ms=ms[0], plain_ms=plain[0]))
    log(f"K3: kernel median {ms[0]:.4f} ms min {ms[1]:.4f}; plain median {plain[0]:.4f} ms min {plain[1]:.4f}")

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
    out = mk.hamming_top2_batched(*args)
    ref = mk.hamming_top2_batched_ref(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("best", "second", "argbest", "col_argmin"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"K4: {name} differs from the plain version")
    if not (bool((out[0][C_REAL:] == mk.BIG).all()) and int(out[3][C_REAL:].abs().sum()) == 0):
        raise AssertionError("K4: padding blocks must give best = BIG and col_argmin 0")
    log(f"K4 {n}x{C_PAD}x{n} ({C_REAL} real blocks): exact")
    ms = timed(lambda: mk.hamming_top2_batched(*args))
    plain = timed(lambda: mk.hamming_top2_batched_ref(*args))
    rows.append(dict(name="hamming_top2_batched", route="cuda", source="visual_slam_tpu_torch/csrc/hamming_top2.cu",
                     replaces="visual_slam_tpu/ops/pallas_kernels.py:99", max_abs_err=0.0, ms=ms[0], plain_ms=plain[0]))
    log(f"K4: kernel median {ms[0]:.4f} ms min {ms[1]:.4f}; plain median {plain[0]:.4f} ms min {plain[1]:.4f}")

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
    ms = timed(lambda: extract_patches32(*args))
    plain = timed(lambda: extract_patches32_ref(*args))
    rows.append(dict(name="extract_patches32", route="cuda", source="visual_slam_tpu_torch/csrc/extract_patches32.cu",
                     replaces="visual_slam_tpu/ops/pallas_patches.py:68", max_abs_err=0.0, ms=ms[0], plain_ms=plain[0]))
    log(f"K5: kernel median {ms[0]:.4f} ms min {ms[1]:.4f}; plain median {plain[0]:.4f} ms min {plain[1]:.4f}")
    return rows


def initial_state(torch, np, step, frame0, zbuf, K, device):
    """Frame-0 keypoints get landmarks from the z-buffer; the same
    landmarks fill the first slots of the 4096-slot arena."""
    from visual_slam_tpu_torch import pipeline

    feats = step.detect(torch.from_numpy(frame0).to(device))
    xy = feats.xy.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    Kinv = np.linalg.inv(K)
    lm = np.zeros((N_FEATURES, 3), np.float32)
    has = np.zeros(N_FEATURES, bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and zbuf[v, u] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * zbuf[v, u]
            has[i] = True
    lm_pos = np.zeros((ARENA, 3), np.float32)
    lm_desc = np.zeros((ARENA, 8), np.int32)
    lm_valid = np.zeros(ARENA, bool)
    lm_pos[:N_FEATURES], lm_desc[:N_FEATURES], lm_valid[:N_FEATURES] = lm, feats.desc.cpu().numpy(), has

    def make(seed: int = 0, on=device):
        s = pipeline.init_track_state(feats, lm, has, np.eye(4), seed=seed, local_map_size=ARENA, device=on)
        return pipeline.set_local_map(s, lm_pos, lm_desc, lm_valid)

    return make, int(has.sum())


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
    expected = [N_LEVELS * N, N - 1, 0, reached]
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
    from visual_slam_tpu_torch.ops.patch_kernels import extract_patches32, patches_and_moments

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, ctypes) -> {_build.LIB.relative_to(ROOT)}")

    t0 = time.perf_counter()
    K, Ts, frames, zbuf = make_world_frames(render_mod, np)
    log(f"rendered {len(frames)} frames {frames.shape[1:]} in {time.perf_counter() - t0:.2f} s")

    rows = check_kernels(torch, np, frames[1], K)

    dev = torch.device("cuda")
    kw = dict(num_features=N_FEATURES, n_levels=N_LEVELS, grid=GRID, pnp_hypotheses=N_HYP,
              local_map=True, width=W, height=H)
    step = pipeline.make_track_step(K, device=dev, **kw)
    chunk = pipeline.make_track_chunk(step)
    make_state, n_lm = initial_state(torch, np, step, frames[0], zbuf, K, dev)
    imgs = torch.from_numpy(frames[1:]).to(dev)
    log(f"arena: {n_lm} landmarks from frame 0 in {ARENA} slots")

    # The tracking path, counted: two chunks of 8 frames.
    counters = (patches_and_moments, mk.hamming_top2, mk.guided_top2, mk.hamming_top2_batched, extract_patches32)
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
    expected = [N_LEVELS * n_frames, n_frames, n_frames, 0, 0]
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
    sync_at = collections.Counter()

    def note_sync(message, *args, **kwargs):
        frames_ = [f for f in traceback.extract_stack() if "visual_slam_tpu_torch" in f.filename]
        if frames_ and "synchroniz" in str(message).lower():
            sync_at[f"{frames_[-1].filename.split('visual_slam_tpu_torch/')[-1]}:{frames_[-1].lineno}"] += 1

    s = make_state()
    torch.cuda.synchronize()
    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(s, imgs[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
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
    cpu_step = pipeline.make_track_step(K, **kw)
    _, cpu_out = cpu_step(make_state(on="cpu"), torch.from_numpy(frames[1]))
    T_cpu = cpu_out.T_w2c.numpy()
    d_R, d_t = np.abs(T_cpu[:3, :3] - T[0, :3, :3]).max(), np.abs(T_cpu[:3, 3] - T[0, :3, 3]).max()
    log(f"frame 1, CUDA step vs CPU step (plain versions): |dR| {d_R:.5f} |dt| {d_t:.4f} m, "
        f"inliers {int(n_inl[0])} vs {int(cpu_out.n_inliers)}")
    if d_R > R_ATOL or d_t > T_ATOL:
        raise AssertionError("CUDA step disagrees with the CPU step on frame 1")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # The pose graphs (whose first solve pays the one-time set-up of
    # torch.func and the solver), then the loop path, counted on its own.
    run_pose_graphs(torch, np, dev)
    loop_launches = run_loop_path(torch, np, step, dev, counters)
    for row, a, b in zip(rows, launches, loop_launches):
        row["launches"] = a + b
    log("launches per kernel (tracking + loop path): "
        f"{[(r['name'], a, b) for r, a, b in zip(rows, launches, loop_launches)]}; "
        "K5 has no caller on either path")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
