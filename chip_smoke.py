#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Prints the card (nvidia-smi name and power limit) and refuses to run
   without CUDA: there is no CPU path.
2. Builds the CUDA kernels from ``visual_slam_tpu_torch/csrc``.
3. Holds each kernel (K1 patches+moments, K2 Hamming top-2, K3 guided
   top-2) against its plain PyTorch version on the card, at the shapes the
   tracking step gives it, and times both.
4. Drives the main path: the fused mono tracking step with a 4096-slot
   local-map arena, 2000 features, 4 levels, 128 RANSAC hypotheses, over a
   rendered 376x1240 sprite world (f = 718.856) in two chunks of 8 frames.
   Checks poses against ground truth and the kernels' launch counts, lists
   the host syncs inside one step, times single steps and chunks, and holds
   one frame against the same step run on the CPU through the plain versions.
5. Prints a JSON line of the kernels, then ``{"ok": true, "device": ...}``
   as the last line. Any failure raises and exits nonzero.
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
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments, patches_and_moments_ref

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
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments

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

    # The main path, counted: two chunks of 8 frames.
    counters = (patches_and_moments, mk.hamming_top2, mk.guided_top2)
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
    expected = [N_LEVELS * n_frames, n_frames, n_frames]
    log(f"launches K1/K2/K3: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} != {expected}")
    for row, n in zip(rows, launches):
        row["launches"] = n

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

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
