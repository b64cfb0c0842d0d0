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
frames instead. ``--solver adam`` sets ``optimization.solver`` and
``--frames N`` cuts the world, as ``scripts/facade_reference.py``'s classes
do.

``stages`` tracks frames ``--snapshot``'s next one to ``--stop`` in the port
on ``--device`` (the recorded draws kept with ``--seeds -1``) and feeds
every stage call of those frames, with the inputs and the RANSAC draws the
run gave it, to the port's function on CPU tensors and to the JAX
package's function (JAX on the CPU): detect, the descriptor match and the
tracker's RANSAC-F, the guided match, RANSAC-PnP, the BA solve (Adam or
LM) and triangulation. One JSON line per call with the differences, held
to ROADMAP's parity tolerances (``STAGE_TOL``). With ``--accel-route`` the
CPU tensors take the route CUDA tensors take, and the RANSAC stages are
also held to JAX's accelerator null vector in float64:

    python scripts/facade_state_probe.py record --device cuda --solver adam --frames 32 --seeds 0 \
        --snap-after 9 10 11 --out results/snaps
    python scripts/facade_state_probe.py stages --device cuda --accel-route --solver adam --frames 32 \
        --snapshot results/snaps/seed0_after9.pkl --seeds -1 --stop 13
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
# Parity tolerances of a stage given identical inputs (ROADMAP, "How the port
# is held to the reference"): detect, keypoints at the same position and
# octave and descriptor bits equal but for near ties (at least 0.99 of
# each); Hamming and guided matches exact; RANSAC (the fundamental matrix
# and PnP), whose float32 LO refits are chaotic in either package, in
# float64 on the well-posed draws (8 or 6 distinct matches): masks exact,
# the pose within 1e-6 (float32 figures printed beside; a call that ends on
# fewer inliers than a minimal set is degenerate, not judged); BA (Adam or LM)
# within tests/test_torch_ba.py's float32 1e-4 (poses) and 1e-3 (points);
# triangulated points within 1e-3 of their distance, their masks within 2.
STAGE_TOL = dict(xy=1e-3, share=0.99, mask=2, pose64=1e-6, ba_T=1e-4, ba_X=1e-3, tri=1e-3)


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


def _t(a):
    """``a`` on the CPU: a tensor, or each tensor of a named tuple."""
    if hasattr(a, "_asdict"):
        return type(a)(*(_t(x) for x in a))
    return a.detach().cpu() if hasattr(a, "detach") else a


class StageLog:
    """Wraps the port facade's stage functions so that each call's inputs
    (with the RANSAC draws made explicit: drawn from the same generator the
    call would have drawn them from) and outputs are kept, as CPU tensors,
    in ``calls``: (frame, stage, inputs, outputs)."""

    def __init__(self, slam):
        from visual_slam_tpu_torch import tracking
        from visual_slam_tpu_torch.backend import adam, optimizer
        from visual_slam_tpu_torch.ops import epipolar, guided_matching, pnp, triangulation

        self.calls, self.frame = [], None
        tr = slam.feature_tracker

        def keep(stage, inputs, out):
            self.calls.append((self.frame, stage, {k: _t(v) for k, v in inputs.items()},
                               {k: _t(v) for k, v in out.items()}))

        detect0, match0 = tr.detectAndCompute, tr.manager.match

        def detect(image):
            f = detect0(image)
            keep("detect", {"image": np.asarray(image)}, f._asdict())
            return f

        def match(f1, f2):
            res = match0(f1, f2)
            keep("match", {"f1": f1, "f2": f2}, res)
            return res

        tr.detectAndCompute, tr.manager.match = detect, match
        rf0, pnp0, gm0, tri0 = epipolar.ransac_fundamental, tracking.ransac_pnp, guided_matching.guided_match, \
            triangulation.triangulate_dlt

        def ransac_f(x1, x2, mask, gen=None, n_hyp=128, thresh=1.0, sample_idx=None):
            if sample_idx is None:
                sample_idx = epipolar._sample_minimal_sets(gen, mask, n_hyp, 8)
            out = rf0(x1, x2, mask, None, n_hyp=n_hyp, thresh=thresh, sample_idx=sample_idx)
            keep("ransac_f", dict(x1=x1, x2=x2, mask=mask, sample_idx=sample_idx, thresh=thresh), out)
            return out

        def ransac_p(X, xy, mask, gen=None, n_hyp=256, thresh=6e-3, sample_idx=None, **kw):
            if sample_idx is None:
                sample_idx = pnp._sample_minimal_sets(gen, mask, n_hyp, 6)
            out = pnp0(X, xy, mask, None, n_hyp=n_hyp, thresh=thresh, sample_idx=sample_idx, **kw)
            keep("pnp", dict(X=X, xy=xy, mask=mask, sample_idx=sample_idx, thresh=thresh), out)
            return out

        def guided(*a, **kw):
            out = gm0(*a, **kw)
            names = ("lm_pos", "lm_desc", "lm_valid", "T_pred", "K", "kp_xy", "kp_desc", "kp_valid", "width",
                     "height")
            keep("guided", dict(zip(names, a), **kw), out)
            return out

        def tri(P1, P2, x1, x2):
            out = tri0(P1, P2, x1, x2)
            keep("triangulate", dict(P1=P1, P2=P2, x1=x1, x2=x2), dict(pts=out[0], ok=out[1]))
            return out

        _UNPATCHED.update(rf=rf0, pnp=pnp0, guided=gm0, tri=tri0, adam=adam.adam_bundle_adjust,
                          lm=optimizer.bundle_adjust_robust)
        epipolar.ransac_fundamental, tracking.ransac_pnp = ransac_f, ransac_p
        guided_matching.guided_match, triangulation.triangulate_dlt = guided, tri
        for mod, name in ((adam, "adam_bundle_adjust"), (optimizer, "bundle_adjust_robust")):
            fn0 = getattr(mod, name)

            def solve(problem, *a, fn0=fn0, name=name, **kw):
                T, X, info = fn0(problem, *a, **kw)
                keep("ba_adam" if name.startswith("adam") else "ba_lm", dict(problem._asdict(), **kw),
                     dict(T=T, X=X, cost0=info["cost0"], cost=info["cost"]))
                return T, X, info

            setattr(mod, name, solve)


def _x64(jax, on: bool):
    """JAX's float64 switch as a context (``jax.enable_x64`` where the
    version has it, else ``jax.experimental.enable_x64``)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(on)
    from jax.experimental import enable_x64, disable_x64

    return enable_x64() if on else disable_x64()


def _jax_rejit(module, name, static):
    """``module.name``'s jitted body jitted anew around a new function
    object (jit caches traces by function, and a trace holds the draws it
    was traced with)."""
    import functools

    import jax

    return jax.jit(functools.partial(getattr(module, name).__wrapped__), static_argnames=static)


def compare_stage(stage, inputs, out, device, jax_tracker, port_tracker, accel=False):
    """Differences of one captured stage call against the port's function
    on CPU tensors and the JAX package's function on the same inputs; with
    ``accel`` the RANSAC stages also against JAX with its accelerator null
    vector (``smallest_eigvec_psd``, the route the port's CUDA tensors
    take), in float64."""
    import jax
    import jax.numpy as jnp
    import torch

    from visual_slam_tpu.ops import epipolar as jepi
    from visual_slam_tpu.ops import pnp as jpnp
    from visual_slam_tpu.ops.detector import Features as JFeatures
    from visual_slam_tpu_torch.ops.detector import Features

    def jfeat(f):
        d = {k: np.asarray(v) for k, v in (f._asdict() if hasattr(f, "_asdict") else f).items()}
        d["desc"] = d["desc"].astype(np.int32).view(np.uint32)
        return JFeatures(**{k: jnp.asarray(v) for k, v in d.items()})

    def inject(idx):
        jepi._sample_minimal_sets = lambda key, mask, n_hyp, k: jnp.asarray(idx)

    res = {}
    key = jax.random.PRNGKey(0)
    if stage == "detect":
        refs = {"cpu": port_tracker.detectAndCompute(inputs["image"])._asdict(),
                "jax": {k: np.asarray(v) for k, v in jax_tracker.detectAndCompute(inputs["image"])._asdict().items()}}
        for name, ref in refs.items():
            v, rv = np.asarray(out["valid"]), np.asarray(ref["valid"])
            same = v & rv & (np.abs(np.asarray(out["xy"]) - np.asarray(ref["xy"])).max(-1) <= STAGE_TOL["xy"]) & (
                np.asarray(out["octave"]) == np.asarray(ref["octave"]))
            d1 = np.asarray(out["desc"]).astype(np.int64) & 0xFFFFFFFF
            d2 = np.asarray(ref["desc"]).astype(np.int64) & 0xFFFFFFFF
            bits = np.unpackbits((d1 ^ d2).astype(np.uint32).view(np.uint8)[same].reshape(-1), axis=None).sum() \
                if same.any() else 0
            share = 1.0 - bits / max(256 * int(same.sum()), 1)
            res[name] = dict(valid=int(v.sum()), ref_valid=int(rv.sum()), same_keypoints=int(same.sum()),
                             bit_share=float(share), ok=bool(same.sum() >= STAGE_TOL["share"] * max(v.sum(), rv.sum())
                                                             and share >= STAGE_TOL["share"]))
    elif stage == "match":
        f1, f2 = (Features(*inputs[k]) for k in ("f1", "f2"))
        refs = {"cpu": port_tracker.manager.match(f1, f2),
                "jax": jax_tracker.manager.match(jfeat(f1), jfeat(f2))}
        for name, ref in refs.items():
            v, rv = np.asarray(out["valid"]), np.asarray(ref["valid"])
            ti, rti = np.asarray(out["train_idx"]), np.asarray(ref["train_idx"])
            n_diff = int((v != rv).sum() + (v & rv & (ti != rti)).sum())
            res[name] = dict(matches=int(v.sum()), differ=n_diff, ok=n_diff == 0)
    elif stage in ("ransac_f", "pnp"):
        ins = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in inputs.items()}
        names = ("x1", "x2", "mask") if stage == "ransac_f" else ("X", "xy", "mask")
        fn, jmod, jname, static = ((_UNPATCHED["rf"], jepi, "ransac_fundamental", ("n_hyp",)) if stage == "ransac_f"
                                   else (_UNPATCHED["pnp"], jpnp, "ransac_pnp", ("n_hyp", "refine_iters")))
        thresh = float(ins["thresh"])

        def port(idx, dev, dtype):
            a = [torch.from_numpy(ins[k]).to(dev, dtype if ins[k].dtype.kind == "f" else None) for k in names]
            return {k: _t(v) for k, v in fn(*a, sample_idx=torch.from_numpy(idx).to(dev), n_hyp=len(idx),
                                              thresh=thresh).items()}

        def jax_run(idx, x64, accel_null=False):
            from visual_slam_tpu.ops import linalg as jlinalg

            null = jlinalg.smallest_eigvec_psd if accel_null else jlinalg.nullspace_vector
            jepi.nullspace_vector = jpnp.nullspace_vector = null
            with _x64(jax, x64):
                inject(idx)
                dt = np.float64 if x64 else np.float32
                a = [jnp.asarray(ins[k].astype(dt) if ins[k].dtype.kind == "f" else ins[k]) for k in names]
                return {k: np.asarray(v) for k, v in _jax_rejit(jmod, jname, static)(*a, key, n_hyp=len(idx),
                                                                                     thresh=thresh).items()}

        def diff(a, b):
            row = dict(inliers=int(np.asarray(a["inliers"]).sum()), ref_inliers=int(np.asarray(b["inliers"]).sum()),
                       mask_differ=int((np.asarray(a["inliers"]) != np.asarray(b["inliers"])).sum()))
            if stage == "pnp":
                row["pose_diff"] = float(max(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max() for k in ("R", "t")))
            else:
                Fa, Fb = (np.asarray(x["F"], np.float64) / np.linalg.norm(np.asarray(x["F"], np.float64))
                          for x in (a, b))
                row["F_diff"] = float(min(np.abs(Fa - Fb).max(), np.abs(Fa + Fb).max()))
            return row

        idx = ins["sample_idx"]
        f32 = {"cpu": port(idx, "cpu", torch.float32), "jax": jax_run(idx, False)}
        well = idx[[len(set(r.tolist())) == len(r) for r in idx]]
        f64 = {"run": port(well, device, torch.float64), "cpu": port(well, "cpu", torch.float64),
               "jax": jax_run(well, True)}
        if accel:
            f64["jax_accel"] = jax_run(well, True, accel_null=True)
            jax_run(well[:1], True)  # JAX's CPU route back in place
        for name in ("cpu", "jax"):
            res[name] = dict(f32=diff(out, f32[name]))
        pairs = [("run", f64["run"], "jax"), ("cpu", f64["cpu"], "jax")]
        if accel:
            pairs.append(("run", f64["run"], "jax_accel"))
        for name, a, ref_name in pairs:
            key = f"{name}_f64_vs_{ref_name}"
            row = diff(a, f64[ref_name])
            if min(row["inliers"], row["ref_inliers"]) < idx.shape[1]:
                # A refit on fewer inliers than a minimal set is rank deficient:
                # its null vector is the solver's choice (ROADMAP Q20.1), no parity.
                res[key] = dict(row, draws=len(well), degenerate=True)
                continue
            ok = row["mask_differ"] == 0 and row.get("pose_diff", row.get("F_diff")) <= STAGE_TOL["pose64"]
            res[key] = dict(row, draws=len(well), ok=bool(ok))
    elif stage == "guided":
        from visual_slam_tpu.ops.guided_matching import guided_match as jgm

        tgm = _UNPATCHED["guided"]

        kw = {k: v for k, v in inputs.items() if k not in ("lm_pos", "lm_desc", "lm_valid", "T_pred", "K", "kp_xy",
                                                         "kp_desc", "kp_valid", "width", "height")}
        names = ("lm_pos", "lm_desc", "lm_valid", "T_pred", "K", "kp_xy", "kp_desc", "kp_valid")
        cpu = tgm(*(inputs[k] for k in names), inputs["width"], inputs["height"], **kw)
        jargs = [jnp.asarray(np.asarray(inputs[k]).astype(np.int32).view(np.uint32)) if "desc" in k else
                 jnp.asarray(np.asarray(inputs[k])) for k in names]
        ref = jgm(*jargs, inputs["width"], inputs["height"], **{k: float(v) for k, v in kw.items()})
        for name, r in (("cpu", cpu), ("jax", ref)):
            v, rv = np.asarray(out["valid"]), np.asarray(r["valid"])
            d = int((v != rv).sum() + (v & rv & (np.asarray(out["lm_idx"]) != np.asarray(r["lm_idx"]))).sum())
            res[name] = dict(pairs=int(v.sum()), differ=d, ok=d == 0)
    elif stage in ("ba_adam", "ba_lm"):
        from visual_slam_tpu.backend import adam as jadam
        from visual_slam_tpu.backend import ba as jba
        from visual_slam_tpu_torch.backend import ba as tba

        fields = ("T_w2c", "points", "uv", "obs_valid", "pose_valid", "pose_fixed")
        kw = {k: v for k, v in inputs.items() if k not in fields}
        problem = {k: np.asarray(inputs[k]) for k in fields}
        if stage == "ba_adam":
            cpu = _UNPATCHED["adam"](tba.BAProblem(**{k: torch.from_numpy(v) for k, v in problem.items()}), **kw)
            ref = jadam.adam_bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()}), **kw)
        else:
            cpu = _UNPATCHED["lm"](tba.BAProblem(**{k: torch.from_numpy(v) for k, v in problem.items()}), **kw)
            ref = jba.bundle_adjust_robust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()}), **kw)
        tT, tX = STAGE_TOL["ba_T"], STAGE_TOL["ba_X"]
        used = problem["obs_valid"].any(1)
        for name, r in (("cpu", cpu), ("jax", ref)):
            dT = float(np.abs(np.asarray(out["T"]) - np.asarray(r[0])).max())
            dX = float(np.abs(np.asarray(out["X"]) - np.asarray(r[1]))[used].max()) if used.any() else 0.0
            res[name] = dict(W=int(problem["pose_valid"].sum()), M=int(used.sum()), dT=dT, dX=dX,
                             cost=float(np.asarray(out["cost"])), ref_cost=float(np.asarray(r[2]["cost"])),
                             ok=bool(dT <= tT and dX <= tX))
    elif stage == "triangulate":
        from visual_slam_tpu.ops.triangulation import triangulate_dlt as jtri

        cpu = _UNPATCHED["tri"](*(inputs[k] for k in ("P1", "P2", "x1", "x2")))
        ref = jtri(*(jnp.asarray(np.asarray(inputs[k])) for k in ("P1", "P2", "x1", "x2")))
        pts = np.asarray(out["pts"])
        scale = np.maximum(np.linalg.norm(pts, axis=-1), 1.0)
        for name, r in (("cpu", cpu), ("jax", ref)):
            ok_a, ok_b = np.asarray(out["ok"]), np.asarray(r[1])
            both = ok_a & ok_b
            rel = float((np.linalg.norm(pts - np.asarray(r[0]), axis=-1) / scale)[both].max()) if both.any() else 0.0
            d = int((ok_a != ok_b).sum())
            res[name] = dict(points=int(ok_a.sum()), ok_differ=d, rel_err=rel,
                             ok=bool(d <= STAGE_TOL["mask"] and rel <= STAGE_TOL["tri"]))
    return res


_UNPATCHED = {}


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
    ap.add_argument("mode", choices=("record", "continue", "stages"))
    ap.add_argument("--impl", choices=("jax", "torch"), default="torch")
    ap.add_argument("--device", default="cpu", help="the port's device (record, continue --impl torch)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True,
                    help="the tracker's RANSAC seeds, one run each; -1 with continue --impl torch on the recording's "
                         "device type keeps the recorded generator states")
    ap.add_argument("--snap-after", type=int, nargs="*", default=[], help="record: frames after which to snapshot")
    ap.add_argument("--snapshot", help="continue, stages: the state to start from")
    ap.add_argument("--stop", type=int, default=None, help="stages: the frame after the last one tracked")
    ap.add_argument("--solver", choices=("lm_schur", "adam"), default="lm_schur", help="optimization.solver")
    ap.add_argument("--frames", type=int, default=None, help="cut the world to this many frames")
    ap.add_argument("--accel-route", action="store_true",
                    help="stages: CPU tensors take the route CUDA tensors take (smallest_eigvec_psd null vectors, "
                         "the closed-form DLT pose), and the RANSAC stages are also held to JAX with its "
                         "accelerator null vector")
    ap.add_argument("--out", default="results/facade_snapshots")
    ap.add_argument("--reseed-filter", action="store_true",
                    help="reseed the feature tracker's fundamental-matrix RANSAC (local mapping's matches) with the "
                         "run's seed too; by default only tracking's RANSAC is reseeded")
    ap.add_argument("--family", default=None,
                    help="a feature family of facade_world.FAMILIES: its detector and matcher, the world cut to "
                         "FAMILY_FRAMES frames")
    args = ap.parse_args()

    import facade_world as fw

    frames, K, Ts = fw.deploy_frames(args.frames or (fw.FAMILY_FRAMES if args.family else 64))
    h, w = frames[0].shape

    def config(Config):
        cfg = fw.family_config(Config, args.family) if args.family else fw.deploy_config(Config)
        cfg.optimization.solver = args.solver
        return cfg

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
    if args.mode == "stages":
        return stages(args, make, install, reseed, frames)
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
                snap.update(after=i, seed=seed, solver=args.solver)
                with open(out_dir / f"seed{seed}_after{i}.pkl", "wb") as f:
                    pickle.dump(snap, f)
        print(json.dumps({"seed": seed, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


def stages(args, make, install, reseed, frames) -> int:
    """The ``stages`` mode: the port from the snapshot on ``args.device``,
    every stage call of the frames up to ``args.stop`` compared against the
    port on the CPU and the JAX package."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.frontend.tracker import FeatureTracker as JTracker
    from visual_slam_tpu_torch.frontend.tracker import FeatureTracker

    if args.accel_route:
        from visual_slam_tpu_torch.ops import epipolar, linalg, pnp, triangulation

        for mod in (epipolar, pnp, triangulation):
            mod.nullspace_vector = linalg.smallest_eigvec_psd
        pnp._dlt_pose = pnp._dlt_pose_closed
    with open(args.snapshot, "rb") as f:
        snap = pickle.load(f)
    slam = make()
    install(slam, snap)
    if args.seeds[0] >= 0:
        reseed(slam, args.seeds[0])
    log = StageLog(slam)
    stop = args.stop or len(frames)
    import facade_world as fw

    for i in range(int(snap["after"]) + 1, stop):
        log.frame = i
        info = slam.track([frames[i]], timestamp=i * fw.DT)
        print(json.dumps({"frame": i, "trace": fw.trace_entry(i, info), "state": info["state"]}), flush=True)
    slam.shutdown()
    cfg = slam.config
    port_tracker = FeatureTracker(cfg.feature, device="cpu")
    jax_tracker = JTracker(JConfig.from_dict(cfg.to_dict()).feature)
    worst = {}
    for frame, stage, inputs, out in log.calls:
        t0 = time.perf_counter()
        res = compare_stage(stage, inputs, out, args.device, jax_tracker, port_tracker, accel=args.accel_route)
        for name, r in res.items():
            if "ok" in r:
                worst.setdefault((stage, name), []).append(r["ok"])
        print(json.dumps({"frame": frame, "stage": stage, "s": round(time.perf_counter() - t0, 2), **res},
                         default=float), flush=True)
    print(json.dumps({"summary": {f"{st}/{name}": f"{sum(v)} of {len(v)} within tolerance"
                                  for (st, name), v in worst.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
