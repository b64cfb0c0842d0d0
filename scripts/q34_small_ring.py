#!/usr/bin/env python3
"""Each package's ``CompiledSLAM`` over the small ring from its own
bootstrap, over tracker RANSAC seeds and CPU thread counts (ROADMAP queue
3, Q3.4: does the port lose the ring where the JAX package does not?).

    JAX_PLATFORMS=cpu python scripts/q34_small_ring.py --impl jax --seeds 0-7
    python scripts/q34_small_ring.py --impl torch --seeds 0-7 --threads 1 2 4 6

The ring is ``tests/loop_pipeline_world.small_ring_frames`` /
``small_ring_config`` (tests/test_compiled_slam.py's
``test_compiled_slam_devpromo_loop_closing``: 100 frames of 0.25 m around
420 sprites at 320x240, 320 features, chunks of 4 with in-chunk promotion,
loop closing on). Each run bootstraps the map itself, then tracks the
rest. The tracker's RANSAC seed is set from here: the script wraps the
``init_track_state`` that each package's ``models/compiled_slam.py``
imports, so every tracking state the run installs is seeded with
``--seeds``' value (neither package is edited). The port runs on the CPU
at each ``--threads`` count (``torch.set_num_threads``).

One JSON line per run: the first LOST frame (null if none), the count of
LOST frames, the closure frames (the frame of each closing keyframe), the
final state, keyframes, and the scale-aligned ATE in metres and in % of
the path over the frames posed.

``--replay-after F ...`` (the port, one ``--threads`` count) instead runs
the port from its own bootstrap at ``--seeds``' first seed up to frame F (a
chunk end), takes its whole state there (the map with its keyframes,
features, landmarks, descriptors and links; the device tracking state with
the reference block, pose, motion model and landmark arena; the host
counters) and tracks the rest of the ring from that state in each package
of ``--continue-impls``, at each of ``--continue-seeds`` (-1: the port
keeps the recorded generator, which repeats the original run). One JSON
line per continuation, as above, with its start frame. Two probes of what
decides a continuation: ``--perturb EPS ...`` adds continuations on the
frames scaled by (1 + EPS) (float rounding moves, the scene does not), and
``--jax-detector`` adds port continuations whose tracking step detects and
describes with the JAX package's detector (everything after detection is
the port's).

    python scripts/q34_small_ring.py --impl torch --seeds 0 --threads 2 --replay-after 12 20 \
        --continue-impls jax torch --continue-seeds -1 0 1 2 3
"""
from __future__ import annotations

import argparse
import copy
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

DT = 0.1


def _seeds(text: str) -> list[int]:
    """'0-7,42' -> [0, 1, ..., 7, 42]."""
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def _package(impl: str):
    """(Config, PinholeCamera, CompiledSLAM, the compiled_slam module,
    ate_rmse, CompiledSLAM keyword arguments) of one package."""
    from importlib import import_module

    if impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        name, kw = "visual_slam_tpu", {}
    else:
        name, kw = "visual_slam_tpu_torch", {"device": "cpu"}
    cs = import_module(name + ".models.compiled_slam")
    return (import_module(name + ".config").Config, import_module(name + ".camera").PinholeCamera,
            cs.CompiledSLAM, cs, import_module(name + ".utils.metrics").ate_rmse, kw)


def _new_slam(impl: str, frames, K):
    import loop_pipeline_world as lpw

    Config, PinholeCamera, CompiledSLAM, _, _, kw = _package(impl)
    h, w = frames[0].shape
    return CompiledSLAM(PinholeCamera(width=w, height=h, K=K), lpw.small_ring_config(Config), **kw)


def _seeded(impl: str, seed: int):
    """(install, restore): every tracking state built by ``impl``'s
    CompiledSLAM is seeded with ``seed`` in between."""
    cs = _package(impl)[3]
    init0 = cs.init_track_state

    def seeded(*a, **k):
        k["seed"] = seed
        return init0(*a, **k)

    def install():
        cs.init_track_state = seeded

    def restore():
        cs.init_track_state = init0

    return install, restore


def _track(slam, frames, start: int, stop_after=None):
    """Track frames[start:] (to ``stop_after`` inclusive); returns (LOST
    frames, bootstrap frame or None, seconds)."""
    t0 = time.perf_counter()
    lost, boot = [], None
    for i in range(start, len(frames) if stop_after is None else stop_after + 1):
        info = slam.track([frames[i]], timestamp=i * DT)
        if boot is None and slam.state.name == "OK":
            boot = i
        if info.get("state") == "LOST":
            lost.append(i)
    return lost, boot, time.perf_counter() - t0


def _report(impl, seed, slam, lost, boot, secs, Ts) -> dict:
    import loop_pipeline_world as lpw

    slam.shutdown()
    ate_rmse = _package(impl)[4]
    frame_of = {kf.keyframe_id: int(round(kf.timestamp / DT)) for kf in slam.map.get_keyframes()}
    ts, Tw = slam.trajectory()
    if not len(ts):
        return dict(impl=impl, seed=seed, first_lost=lost[0] if lost else None, lost_frames=len(lost),
                    state=slam.state.name)
    rmse, pct = lpw.ate_pct(ate_rmse, np.asarray(ts), np.asarray(Tw), Ts, dt=DT)
    return dict(impl=impl, seed=seed, bootstrap_frame=boot, first_lost=lost[0] if lost else None,
                lost_frames=len(lost), closures=[frame_of.get(a) for a, _ in slam.loop_closing.closed_loops],
                state=slam.state.name, keyframes=slam.map.num_keyframes(), frames_posed=len(ts),
                ate_m=rmse, ate_pct=pct, seconds=round(secs, 1))


def run_once(impl: str, seed: int, frames, K, Ts) -> dict:
    install, restore = _seeded(impl, seed)
    install()
    try:
        slam = _new_slam(impl, frames, K)
        lost, boot, secs = _track(slam, frames, 0)
    finally:
        restore()
    return _report(impl, seed, slam, lost, boot, secs, Ts)


FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _u32(desc):
    return np.ascontiguousarray(_np(desc)).astype(np.int32).view(np.uint32) if desc is not None else None


def snapshot(slam) -> dict:
    """The port's CompiledSLAM state at a chunk end, as numpy (descriptors
    as uint32 words)."""
    from visual_slam_tpu_torch.map import KeyFrame, MapPoint
    from visual_slam_tpu_torch.map.frame import FrameBase

    assert not slam._chunk_buf and slam._pending is None
    m = slam.map
    points = {mp.id: mp for mp in m.get_map_points()}
    kfs = []
    for kf in m.get_keyframes():
        f = kf.get_features(0)
        feats = {k: _np(getattr(f, k)) for k in FIELDS}
        feats["desc"] = _u32(feats["desc"])
        links = []
        for (cam, kp), mp in kf.map_points.items():
            points.setdefault(mp.id, mp)
            links.append((int(cam), int(kp), int(mp.id)))
        kfs.append(dict(keyframe_id=int(kf.keyframe_id), id=int(kf.id), timestamp=float(kf.timestamp),
                        T_w2c=np.array(kf.T_w2c), features=feats, map_points=links))
    for mp in slam._lm_arena:
        points.setdefault(mp.id, mp)
    in_map = {mp.id for mp in m.get_map_points()}
    pts = [dict(id=int(mp.id), in_map=mp.id in in_map, position=np.array(mp.position), is_bad=bool(mp.is_bad),
                descriptor=_u32(mp.descriptor),
                observations=[tuple(int(x) for x in o) for o in mp.observations.items()])
           for mp in points.values()]
    st = slam._track_state
    track = {k: _np(getattr(st, k)) for k in ("ref_landmarks", "ref_has_landmark", "T_w2c", "T_rel", "lm_pos",
                                              "lm_valid")}
    track["lm_desc"] = _u32(st.lm_desc)
    track["ref_feats"] = {k: _np(getattr(st.ref_feats, k)) for k in FIELDS}
    track["ref_feats"]["desc"] = _u32(track["ref_feats"]["desc"])
    peek = lambda owner, attr: next(copy.copy(getattr(owner, attr)))  # noqa: E731
    return dict(keyframes=kfs, points=pts, track=track, ref_kf=int(slam._ref_kf.keyframe_id),
                arena=[int(mp.id) for mp in slam._lm_arena], frames_since_kf=int(slam._frames_since_kf),
                promos_since_heavy=int(slam._promos_since_heavy), gauge_log=list(m._gauge_log),
                gen=st.gen.get_state().numpy(),
                next_ids=dict(frame=peek(FrameBase, "_ids"), keyframe=peek(KeyFrame, "_kf_ids"),
                              point=peek(MapPoint, "_ids")))


def install(impl: str, slam, snap, seed: int) -> None:
    """Continue ``slam`` (a new CompiledSLAM of ``impl``) from ``snap``; the
    RANSAC generator restarts at ``seed`` (-1, the port only: the recorded
    state)."""
    from importlib import import_module

    name = "visual_slam_tpu" if impl == "jax" else "visual_slam_tpu_torch"
    mm = import_module(name + ".map")
    FrameBase = import_module(name + ".map.frame").FrameBase
    Features = import_module(name + ".ops.detector").Features
    TrackState = import_module(name + ".pipeline").TrackState
    State = import_module(name + ".state").State
    if impl == "jax":
        import jax
        import jax.numpy as jnp

        up = jnp.asarray
        desc = lambda d: jnp.asarray(d)  # noqa: E731
    else:
        import torch

        from visual_slam_tpu_torch.interop import desc_to_int32

        up = torch.from_numpy
        desc = lambda d: torch.from_numpy(desc_to_int32(d))  # noqa: E731

    def feats(d):
        return Features(**{k: (desc(v) if k == "desc" else up(np.array(v))) for k, v in d.items()})

    m = mm.Map()
    for k in snap["keyframes"]:
        kf = mm.KeyFrame(features=[feats(k["features"])], timestamp=k["timestamp"])
        kf.id, kf.keyframe_id = k["id"], k["keyframe_id"]
        kf.update_pose(k["T_w2c"])
        m.add_keyframe(kf)
    pts = {}
    for p in snap["points"]:
        d = p["descriptor"]
        mp = mm.MapPoint(p["position"], descriptor=None if d is None else (d if impl == "jax" else d.view(np.int32)))
        mp.id, mp.is_bad = p["id"], p["is_bad"]
        for kf_id, cam, kp in p["observations"]:
            mp.add_observation(kf_id, cam, kp)
        pts[p["id"]] = mp
        if p["in_map"]:
            m.add_map_point(mp)
    for k in snap["keyframes"]:
        kf = m.get_keyframe_by_id(k["keyframe_id"])
        for cam, kp, pid in k["map_points"]:
            kf.map_points[(cam, kp)] = pts[pid]
    m._gauge_log = list(snap["gauge_log"])
    slam.map = slam._initializer.map = m
    if slam.loop_closing is not None:
        slam.loop_closing.map = m
    slam._initializer.initialized = True
    slam.state = State.OK
    slam._ref_kf = m.get_keyframe_by_id(snap["ref_kf"])
    slam._lm_arena = [pts[i] for i in snap["arena"]]
    slam._frames_since_kf = snap["frames_since_kf"]
    slam._promos_since_heavy = snap["promos_since_heavy"]
    t = snap["track"]
    if impl == "jax":
        gen = jax.random.PRNGKey(seed)
    else:
        gen = torch.Generator(device="cpu")
        if seed >= 0:
            gen.manual_seed(seed)
        else:
            gen.set_state(torch.from_numpy(snap["gen"]))
    slam._track_state = TrackState(feats(t["ref_feats"]), up(t["ref_landmarks"]), up(t["ref_has_landmark"]),
                                   up(t["T_w2c"]), up(t["T_rel"]), gen, lm_pos=up(t["lm_pos"]),
                                   lm_desc=desc(t["lm_desc"]), lm_valid=up(t["lm_valid"]))
    ids = snap["next_ids"]
    FrameBase._ids = itertools.count(ids["frame"])
    mm.KeyFrame._kf_ids = itertools.count(ids["keyframe"])
    mm.MapPoint._ids = itertools.count(ids["point"])


def _jax_detector():
    """A stand-in for the port's ``pipeline.detect_and_describe`` that runs
    the JAX package's detector on the image (numpy in, port features out)."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops import detector as jdet
    from visual_slam_tpu_torch.interop import features_from_numpy

    def detect(img, sampling, moment_w, num_features=1000, threshold=20.0, n_levels=4, scale=1.2, grid=8,
               edge_margin=16):
        f = jdet.detect_and_describe(jnp.asarray(img.float().cpu().numpy()), num_features=num_features,
                                     threshold=threshold, n_levels=n_levels, scale=scale, grid=grid,
                                     edge_margin=edge_margin)
        return features_from_numpy(jax.device_get(f), img.device)

    return detect


def replay(args, frames, K, Ts) -> None:
    import torch

    torch.set_num_threads(args.threads[0])
    seed = _seeds(args.seeds)[0]
    snaps = {}
    on, off = _seeded("torch", seed)
    on()
    try:
        slam = _new_slam("torch", frames, K)
        i = 0
        for f in sorted(args.replay_after):
            _track(slam, frames, i, stop_after=f)
            i = f + 1
            snaps[f] = snapshot(slam)
    finally:
        off()
    from visual_slam_tpu_torch import pipeline

    variants = [(impl, 0.0, False) for impl in args.continue_impls]
    variants += [(impl, eps, False) for eps in args.perturb for impl in args.continue_impls]
    if args.jax_detector:
        variants.append(("torch", 0.0, True))
    detect0 = pipeline.detect_and_describe
    for f, snap in snaps.items():
        for impl, eps, jax_det in variants:
            seq = [np.asarray(im, np.float32) * np.float32(1.0 + eps) for im in frames] if eps else frames
            for cseed in args.continue_seeds:
                if impl == "jax" and cseed < 0:
                    continue
                slam = _new_slam(impl, frames, K)
                install(impl, slam, snap, cseed)
                if jax_det:
                    pipeline.detect_and_describe = _jax_detector()
                try:
                    lost, _, secs = _track(slam, seq, f + 1)
                finally:
                    pipeline.detect_and_describe = detect0
                row = _report(impl, cseed, slam, lost, None, secs, Ts)
                print(json.dumps(dict(row, start=f + 1, threads=args.threads[0], snapshot_seed=seed, perturb=eps,
                                      jax_detector=jax_det)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--threads", type=int, nargs="+", default=[2], help="torch intra-op threads (the port)")
    ap.add_argument("--replay-after", type=int, nargs="*", default=[], help="frames (chunk ends) to snapshot at")
    ap.add_argument("--continue-impls", nargs="+", default=["jax", "torch"])
    ap.add_argument("--continue-seeds", type=int, nargs="+", default=[-1, 0, 1, 2, 3])
    ap.add_argument("--perturb", type=float, nargs="*", default=[], help="relative image scalings to add")
    ap.add_argument("--jax-detector", action="store_true")
    args = ap.parse_args()

    import loop_pipeline_world as lpw

    frames, K, Ts = lpw.small_ring_frames()
    if args.replay_after:
        if "jax" in args.continue_impls or args.jax_detector:
            _package("jax")
        replay(args, frames, K, Ts)
        return 0
    for threads in (args.threads if args.impl == "torch" else [None]):
        if threads is not None:
            import torch

            torch.set_num_threads(threads)
        for seed in _seeds(args.seeds):
            row = run_once(args.impl, seed, frames, K, Ts)
            print(json.dumps(dict(row, threads=threads)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
