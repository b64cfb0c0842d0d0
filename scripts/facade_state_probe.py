#!/usr/bin/env python3
"""Where a facade run of the deployment world goes LOST, and whether the
JAX package would have done the same from the same state.

``record`` runs the port's ``SLAM`` over ``tests/facade_world.py``'s
deployment world at the given RANSAC seeds, prints each run's trace (per
frame: guided / 3D-2D pairs / PnP inliers, ``K`` a keyframe, ``R`` a
relocalization) and, on every LOST frame, what relocalization tried: the
3D-2D pairs and PnP inliers per candidate keyframe, the guided refine's
pairs and its inliers and ratio. ``--snap-after F ...`` writes the whole
facade state after frame F (the map with its keyframes, features,
landmarks, descriptors and links; the tracking state; covisibility; the
id counters) to ``--out`` as a pickle of numpy arrays.

``continue`` installs such a state into either package's ``SLAM`` on the
CPU (or the port's on the card) and tracks the rest of the world from it,
at each of the given seeds, with the same printout.

    python scripts/facade_state_probe.py record --device cuda --seeds 5 --snap-after 14 20 --out results/snaps
    JAX_PLATFORMS=cpu python scripts/facade_state_probe.py continue --impl jax \\
        --snapshot results/snaps/seed5_after14.pkl --seeds 0 1 2 3
    python scripts/facade_state_probe.py continue --impl torch --device cpu \\
        --snapshot results/snaps/seed5_after14.pkl --seeds 0 1 2 3

``--family gradhist`` (a family of ``facade_world.FAMILIES``) runs that
family's detector and matcher over the world's first ``FAMILY_FRAMES``
frames instead.
"""
from __future__ import annotations

import argparse
import copy
import itertools
import json
import pickle
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def snapshot(slam) -> dict:
    """The port facade's state as plain numpy (descriptors as uint32 words)."""
    from visual_slam_tpu_torch.map import KeyFrame, MapPoint
    from visual_slam_tpu_torch.map.frame import FrameBase

    m, tr = slam.map, slam.tracking
    kfs, points = [], {}
    for mp in m.get_map_points():
        points[mp.id] = mp
    for kf in m.get_keyframes():
        f = kf.get_features(0)
        feats = {k: _np(getattr(f, k)) for k in FIELDS}
        feats["desc"] = feats["desc"].astype(np.int32).view(np.uint32)
        links = []
        for (cam, kp), mp in kf.map_points.items():
            points.setdefault(mp.id, mp)
            links.append((int(cam), int(kp), int(mp.id)))
        kfs.append(dict(keyframe_id=int(kf.keyframe_id), id=int(kf.id), timestamp=float(kf.timestamp),
                        T_w2c=np.array(kf.T_w2c), features=feats, map_points=links))
    in_map = {mp.id for mp in m.get_map_points()}
    pts = [dict(id=int(mp.id), in_map=mp.id in in_map, position=np.array(mp.position), is_bad=bool(mp.is_bad),
                descriptor=None if mp.descriptor is None else np.asarray(mp.descriptor).astype(np.int32).view(np.uint32),
                observations=[tuple(int(x) for x in o) for o in mp.observations.items()]) for mp in points.values()]
    peek = lambda owner, attr: next(copy.copy(getattr(owner, attr)))  # noqa: E731
    return dict(
        keyframes=kfs, points=pts, state=slam.state.name,
        reference_keyframe_id=int(tr.reference_keyframe.keyframe_id), last_frame_T=np.array(tr.last_frame.T_w2c),
        last_frame_id=int(tr.last_frame.id), motion_model=np.array(tr.motion_model),
        last_keyframe_frame_id=int(tr.last_keyframe_frame_id),
        gauge_log=[(float(s), np.asarray(b)) for s, b in m._gauge_log],
        covisibility=copy.deepcopy(slam.local_mapping.covisibility),
        trigger_count=int(slam.local_handler._trigger_count),
        next_ids=dict(frame=peek(FrameBase, "_ids"), keyframe=peek(KeyFrame, "_kf_ids"), point=peek(MapPoint, "_ids")),
        rng=dict(device=slam.device.type, tracking=tr._gen.get_state().numpy(),
                 tracker=slam.feature_tracker._gen.get_state().numpy()),
    )


def _set_counters(FrameBase, KeyFrame, MapPoint, ids) -> None:
    FrameBase._ids = itertools.count(ids["frame"])
    KeyFrame._kf_ids = itertools.count(ids["keyframe"])
    MapPoint._ids = itertools.count(ids["point"])


def install_port(slam, snap) -> None:
    import torch

    from visual_slam_tpu_torch import interop
    from visual_slam_tpu_torch.map import KeyFrame, MapPoint
    from visual_slam_tpu_torch.map.frame import FrameBase
    from visual_slam_tpu_torch.state import State

    pts = {}
    for p in snap["points"]:
        pts[p["id"]] = SimpleNamespace(id=p["id"], position=p["position"], is_bad=p["is_bad"],
                                       descriptor=p["descriptor"],
                                       observations=SimpleNamespace(items=lambda o=p["observations"]: iter(o)))
    kfs = [SimpleNamespace(keyframe_id=k["keyframe_id"], id=k["id"], timestamp=k["timestamp"], T_w2c=k["T_w2c"],
                           features=[SimpleNamespace(**k["features"])],
                           map_points={(c, kp): pts[pid] for c, kp, pid in k["map_points"]})
           for k in snap["keyframes"]]
    interop.install_slam_state(slam, kfs, [pts[p["id"]] for p in snap["points"] if p["in_map"]], snap["reference_keyframe_id"],
                               snap["last_frame_T"], snap["motion_model"], snap["last_keyframe_frame_id"],
                               snap["last_frame_id"], gauge_log=snap["gauge_log"])
    slam.state = State[snap["state"]]
    slam.local_mapping.covisibility = copy.deepcopy(snap["covisibility"])
    slam.local_handler._trigger_count = snap["trigger_count"]
    _set_counters(FrameBase, KeyFrame, MapPoint, snap["next_ids"])
    if snap["rng"]["device"] == slam.device.type:  # the draws continue as recorded unless reseeded
        slam.tracking._gen.set_state(torch.from_numpy(snap["rng"]["tracking"]))
        slam.feature_tracker._gen.set_state(torch.from_numpy(snap["rng"]["tracker"]))


def install_jax(slam, snap) -> None:
    import jax.numpy as jnp

    from visual_slam_tpu.map import KeyFrame, Map, MapPoint
    from visual_slam_tpu.map.frame import Frame, FrameBase
    from visual_slam_tpu.map.pose import Pose
    from visual_slam_tpu.ops.detector import Features
    from visual_slam_tpu.state import State

    m = Map()
    for k in snap["keyframes"]:
        kf = KeyFrame(features=[Features(**{f: jnp.asarray(v) for f, v in k["features"].items()})],
                      timestamp=k["timestamp"])
        kf.id, kf.keyframe_id = k["id"], k["keyframe_id"]
        kf.update_pose(k["T_w2c"])
        m.add_keyframe(kf)
    pts = {}
    for p in snap["points"]:
        mp = MapPoint(p["position"])
        mp.id, mp.is_bad, mp.descriptor = p["id"], p["is_bad"], p["descriptor"]
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
    for owner in (slam, slam.tracking, slam.tracking.initializer, slam.local_mapping, slam.local_mapping.handler,
                  slam.local_handler, slam.global_handler, slam.loop_closing):
        if owner is not None:
            owner.map = m
    tr = slam.tracking
    tr.reference_keyframe = m.get_keyframe_by_id(snap["reference_keyframe_id"])
    tr.last_frame = tr.current_frame = Frame(pose=Pose(snap["last_frame_T"]))
    tr.last_frame.id = snap["last_frame_id"]
    tr.motion_model = np.array(snap["motion_model"])
    tr.last_keyframe_frame_id = snap["last_keyframe_frame_id"]
    tr._gauge_seen = tr._gather_gauge_version = m.gauge_version
    tr.initializer.initialized = True
    slam.state = State[snap["state"]]
    slam.local_mapping.covisibility = copy.deepcopy(snap["covisibility"])
    slam.local_handler._trigger_count = snap["trigger_count"]
    _set_counters(FrameBase, KeyFrame, MapPoint, snap["next_ids"])


def watch_relocalization(slam, log: list) -> None:
    """Record what relocalization tries on the frames that start LOST (the
    method names are the same in both packages)."""
    tr = slam.tracking

    def wrap(name, note):
        fn = getattr(tr, name)

        def inner(*a, **kw):
            out = fn(*a, **kw)
            if slam.state.name == "LOST" and log:
                log[-1].append(note(a, kw, out))
            return out
        setattr(tr, name, inner)

    wrap("_track_reference_keyframe",
         lambda a, kw, out: f"kf{a[1].keyframe_id}:{int(np.asarray(out[3]).sum())}")
    wrap("_optimize_pose",
         lambda a, kw, out: f"pnp{int(np.asarray(a[3]).sum())}->{out['n_inliers']}")
    wrap("_track_guided",
         lambda a, kw, out: f"guided{'-' if out is None else int(np.asarray(out['valid']).sum())}")


def run(slam, frames, start: int, reseed, seed, Ts, summarize):
    import facade_world as fw

    if seed >= 0:
        reseed(slam, seed)
    trace, reloc = [], []
    watch_relocalization(slam, reloc)
    states, poses = [], []
    for i in range(start, len(frames)):
        lost = slam.state.name == "LOST"
        if lost:
            reloc.append([f"{i}:"])
        info = slam.track([frames[i]], timestamp=i * fw.DT)
        trace.append(fw.trace_entry(i, info))
        states.append(info["state"])
        if info["state"] == "OK":
            poses.append((i * fw.DT, np.array(slam.tracking.last_frame.T_w2c)))
        yield i, info
    slam.shutdown()
    out = summarize(slam, states, poses)
    out.update(ransac_seed=seed, start=start, trace=" ".join(trace), reloc=[" ".join(r) for r in reloc[:12]])
    print(json.dumps(out, default=float), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "continue"))
    ap.add_argument("--impl", choices=("jax", "torch"), default="torch")
    ap.add_argument("--device", default="cpu", help="the port's device (record, continue --impl torch)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True,
                    help="the tracker's RANSAC seeds, one run each; -1 with continue --impl torch on the recording's "
                         "device type keeps the recorded generator states")
    ap.add_argument("--snap-after", type=int, nargs="*", default=[], help="record: frames after which to snapshot")
    ap.add_argument("--snapshot", help="continue: the state to start from")
    ap.add_argument("--out", default="results/facade_snapshots")
    ap.add_argument("--reseed-filter", action="store_true",
                    help="reseed the feature tracker's fundamental-matrix RANSAC (local mapping's matches) with the "
                         "run's seed too; by default only tracking's RANSAC is reseeded")
    ap.add_argument("--family", default=None,
                    help="a feature family of facade_world.FAMILIES: its detector and matcher, the world cut to "
                         "FAMILY_FRAMES frames")
    args = ap.parse_args()

    import facade_world as fw

    frames, K, Ts = fw.deploy_frames(fw.FAMILY_FRAMES if args.family else 64)
    h, w = frames[0].shape

    def config(Config):
        return fw.family_config(Config, args.family) if args.family else fw.deploy_config(Config)

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from visual_slam_tpu.camera import PinholeCamera
        from visual_slam_tpu.config import Config
        from visual_slam_tpu.slam import SLAM
        from visual_slam_tpu.utils.metrics import ate_rmse

        make = lambda: SLAM(PinholeCamera(width=w, height=h, K=K), config(Config))  # noqa: E731
        install = install_jax

        def reseed(slam, seed):
            slam.tracking._key = jax.random.PRNGKey(seed)
            if args.reseed_filter:
                slam.feature_tracker._key = jax.random.PRNGKey(seed)
    else:
        from visual_slam_tpu_torch.camera import PinholeCamera
        from visual_slam_tpu_torch.config import Config
        from visual_slam_tpu_torch.slam import SLAM
        from visual_slam_tpu_torch.utils.metrics import ate_rmse

        make = lambda: SLAM(PinholeCamera(width=w, height=h, K=K), config(Config), device=args.device)  # noqa: E731
        install = install_port

        def reseed(slam, seed):
            slam.tracking._gen.manual_seed(seed)
            if args.reseed_filter:
                slam.feature_tracker._gen.manual_seed(seed)

    def summarize(slam, states, poses):
        out = {"impl": args.impl, "device": args.device if args.impl == "torch" else "cpu", "state": slam.state.name,
               "keyframes": slam.map.num_keyframes(), "landmarks": slam.map.num_map_points(),
               "lost": sum(s == "LOST" for s in states),
               "relocalizations": sum(1 for s0, s1 in zip(states, states[1:]) if s0 == "LOST" and s1 == "OK")}
        traj = slam.trajectory()
        if len(traj) >= 3:
            out["ate_keyframes_pct"] = fw.ate(ate_rmse, [t for _, t, _ in traj], [T for _, _, T in traj], Ts)["pct"]
        return out

    out_dir = Path(args.out)
    for seed in args.seeds:
        t0 = time.perf_counter()
        slam = make()
        start = 0
        if args.mode == "continue":
            with open(args.snapshot, "rb") as f:
                snap = pickle.load(f)
            install(slam, snap)
            start = int(snap["after"]) + 1
        for i, _ in run(slam, frames, start, reseed, seed, Ts, summarize):
            if i in args.snap_after:
                out_dir.mkdir(parents=True, exist_ok=True)
                snap = snapshot(slam)
                snap["after"], snap["seed"] = i, seed
                with open(out_dir / f"seed{seed}_after{i}.pkl", "wb") as f:
                    pickle.dump(snap, f)
        print(json.dumps({"seed": seed, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
