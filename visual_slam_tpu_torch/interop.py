"""Carry tracking state and maps across from the JAX package, as numpy arrays.

The system has no weights: what carries over is the state (reference
features, landmarks, poses, the arena, the map) and the constants, which
the port builds from the same seeds. Descriptor words are ``uint32`` in the
JAX package and ``int32`` here, bit for bit (``ndarray.view``). Nothing here
imports JAX: the arguments are any objects with the JAX fields, holding
numpy arrays, anything ``np.asarray`` reads, or the port's own tensors.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .backend.ba import BAProblem
from .map import Frame, KeyFrame, Map, MapPoint
from .map.pose import Pose
from .ops.detector import Features
from .pipeline import PromoteRecord, TrackOutput, TrackState
from .utils.tree import as_numpy as _np


def _t(x, dtype, device):
    return None if x is None else torch.tensor(_np(x), dtype=dtype).to(device)


def desc_to_int32(desc) -> np.ndarray:
    """uint32 descriptor words (or the port's int32 words) -> int32 bits, a
    writable copy."""
    return np.array(_np(desc)).view(np.int32)


def desc_to_uint32(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptor words -> the JAX package's uint32 bits."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def features_from_numpy(feats, device=None) -> Features:
    """The port's ``Features`` on ``device`` from an object with the JAX
    ``Features`` fields."""

    return Features(
        xy=_t(feats.xy, torch.float32, device),
        response=_t(feats.response, torch.float32, device),
        angle=_t(feats.angle, torch.float32, device),
        octave=_t(feats.octave, torch.int32, device),
        size=_t(feats.size, torch.float32, device),
        desc=torch.from_numpy(desc_to_int32(feats.desc)).to(device),
        valid=_t(feats.valid, torch.bool, device),
    )


def track_state_from_numpy(state, device=None, seed: int = 0) -> TrackState:
    """The port's ``TrackState`` on ``device`` from the leaves of a JAX
    ``TrackState``. The JAX PRNG key does not carry over: RANSAC draws come
    from a new generator seeded with ``seed``."""

    device = torch.device(device) if device is not None else torch.device("cpu")
    return TrackState(
        ref_feats=features_from_numpy(state.ref_feats, device),
        ref_landmarks=_t(state.ref_landmarks, torch.float32, device),
        ref_has_landmark=_t(state.ref_has_landmark, torch.bool, device),
        T_w2c=_t(state.T_w2c, torch.float32, device),
        T_rel=_t(state.T_rel, torch.float32, device),
        gen=torch.Generator(device=device).manual_seed(seed),
        lm_pos=_t(state.lm_pos, torch.float32, device),
        lm_desc=None if state.lm_desc is None else torch.from_numpy(desc_to_int32(state.lm_desc)).to(device),
        lm_valid=_t(state.lm_valid, torch.bool, device),
    )


def batched_track_state_from_numpy(np_states, device=None, seeds=()) -> TrackState:
    """The port's batched ``TrackState`` (``parallel.multiseq``) from the JAX
    package's stacked one (``jax.tree.map(jnp.stack, ...)`` of B states, as
    numpy arrays): every leaf bit for bit with its leading B, and one new
    generator per sequence, seeded with ``seeds[b]`` (the JAX keys do not
    carry over)."""
    state = track_state_from_numpy(np_states, device)
    if len(seeds) != state.T_w2c.shape[0]:
        raise ValueError(f"{len(seeds)} seeds for a batch of {state.T_w2c.shape[0]} states")
    dev = state.T_w2c.device
    return state._replace(gen=tuple(torch.Generator(device=dev).manual_seed(int(s)) for s in seeds))


def track_output_from_numpy(out, device=None) -> TrackOutput:
    """The port's ``TrackOutput`` from an object with the JAX fields; the
    stereo depth fields, ``None`` on a mono step, become zeros. Leading
    (chunk) axes are kept."""

    feats = features_from_numpy(out.features, device)
    shape = tuple(feats.valid.shape)
    kp_z = getattr(out, "kp_z", None)
    kp_z_valid = getattr(out, "kp_z_valid", None)
    return TrackOutput(
        T_w2c=_t(out.T_w2c, torch.float32, device),
        n_inliers=_t(out.n_inliers, torch.int64, device),
        n_matches=_t(out.n_matches, torch.int64, device),
        features=feats,
        match_train_idx=_t(out.match_train_idx, torch.int64, device),
        match_valid=_t(out.match_valid, torch.bool, device),
        pnp_inliers=_t(out.pnp_inliers, torch.bool, device),
        guided_idx=_t(out.guided_idx, torch.int64, device),
        guided_valid=_t(out.guided_valid, torch.bool, device),
        kp_z=torch.zeros(shape, device=device) if kp_z is None else _t(kp_z, torch.float32, device),
        kp_z_valid=(torch.zeros(shape, dtype=torch.bool, device=device) if kp_z_valid is None
                    else _t(kp_z_valid, torch.bool, device)),
    )


def promote_record_from_numpy(rec, device=None) -> PromoteRecord:
    """The port's ``PromoteRecord`` from an object with the JAX fields."""

    return PromoteRecord(promoted=_t(rec.promoted, torch.bool, device),
                         ref_pos=_t(rec.ref_pos, torch.float32, device),
                         ref_has=_t(rec.ref_has, torch.bool, device), ref_tri=_t(rec.ref_tri, torch.bool, device))


def ba_problem_from_numpy(problem, device=None) -> BAProblem:
    """The port's dense ``BAProblem`` from an object with the JAX fields."""

    return BAProblem(T_w2c=_t(problem.T_w2c, torch.float32, device), points=_t(problem.points, torch.float32, device),
                     uv=_t(problem.uv, torch.float32, device), obs_valid=_t(problem.obs_valid, torch.bool, device),
                     pose_valid=_t(problem.pose_valid, torch.bool, device),
                     pose_fixed=_t(problem.pose_fixed, torch.bool, device))


def _copy_depths(dst, src) -> None:
    """The per-keypoint depths (``kp_z``, ``kp_z_valid``: stereo and RGB-D
    frames) and the depth map of ``src``, where it has them, onto ``dst``."""
    z, ok = getattr(src, "kp_z", None), getattr(src, "kp_z_valid", None)
    if z is not None and ok is not None:
        dst.kp_z, dst.kp_z_valid = np.array(_np(z), np.float32), np.array(_np(ok), bool)
    if getattr(src, "depth", None) is not None:
        dst.depth = np.asarray(src.depth)


def keyframe_from_numpy(features, T_w2c, keyframe_id: int, frame_id: int | None = None,
                        timestamp: float = 0.0, device=None, depths=None) -> KeyFrame:
    """The port's ``KeyFrame`` with the given ids and pose, its feature
    blocks (one per camera, objects with the JAX ``Features`` fields) on
    ``device``, and the per-keypoint depths and depth map of ``depths`` (an
    object with ``kp_z``, ``kp_z_valid``, ``depth``), if given. A copy takes
    no new keyframe id from the class counter (nor a frame id, when
    ``frame_id`` is given): loop closing's cooldown reads the gaps between
    ids."""
    kf = KeyFrame(features=[features_from_numpy(f, device) for f in features], timestamp=timestamp,
                  pose=Pose(_np(T_w2c)), frame_id=frame_id, keyframe_id=keyframe_id)
    if depths is not None:
        _copy_depths(kf, depths)
    return kf


def frame_from_numpy(src, device=None) -> Frame:
    """The port's ``Frame`` holding what a JAX ``Frame`` holds: its id,
    timestamp, pose, images, every camera's feature block on ``device``,
    the depth map and the per-keypoint depths (the carry-over of an
    in-flight stereo or RGB-D frame)."""
    frame = Frame(images=list(src.images), images_gray=list(src.images_gray),
                  features=[features_from_numpy(f, device) for f in src.features], timestamp=src.timestamp,
                  pose=Pose(_np(src.T_w2c)), frame_id=src.id)
    _copy_depths(frame, src)
    return frame


def map_from_numpy(keyframes, points, device=None) -> Map:
    """The port's ``Map`` holding the same keyframes and landmarks as a JAX
    ``Map`` (``map_from_numpy(m.get_keyframes(), m.get_map_points())``), or
    as any objects with their fields: keyframes with ``keyframe_id``, ``id``,
    ``timestamp``, ``T_w2c``, ``features`` (every camera's), ``map_points``
    ({(cam, kp): point}) and optionally ``kp_z``, ``kp_z_valid`` and
    ``depth``; points with ``id``, ``position``, ``is_bad``, optionally
    ``descriptor`` and ``color``, and ``observations.items()`` ((kf_id,
    cam, kp) triples). Ids, insertion order, observations and keyframe
    links are kept, so host bookkeeping iterates in the same order in both
    packages."""
    m = Map()
    for src in keyframes:
        m.add_keyframe(keyframe_from_numpy(src.features, src.T_w2c, src.keyframe_id, frame_id=src.id,
                                           timestamp=src.timestamp, device=device, depths=src))
    def copy_point(src) -> MapPoint:
        desc = getattr(src, "descriptor", None)
        color = getattr(src, "color", None)
        mp = MapPoint(_np(src.position), color=None if color is None else _np(color),
                      descriptor=None if desc is None else desc_to_int32(desc))
        mp.id = int(src.id)
        mp.is_bad = bool(src.is_bad)
        for kf_id, cam_id, kp_idx in src.observations.items():
            mp.add_observation(int(kf_id), int(cam_id), int(kp_idx))
        return mp

    by_id = {}
    for src in points:
        mp = by_id[int(src.id)] = copy_point(src)
        m.add_map_point(mp)
    for src in keyframes:
        kf = m.get_keyframe_by_id(int(src.keyframe_id))
        for (cam_id, kp_idx), smp in src.map_points.items():
            if int(smp.id) not in by_id:  # a link to a landmark the map no longer holds (culled, fused)
                by_id[int(smp.id)] = copy_point(smp)
            kf.map_points[(int(cam_id), int(kp_idx))] = by_id[int(smp.id)]
    return m


def _advance_ids(owner, attr: str, nxt: int) -> None:
    """Move the id counter ``owner.attr`` to at least ``nxt``."""
    setattr(owner, attr, itertools.count(max(next(getattr(owner, attr)), nxt)))


def install_slam_state(slam, keyframes, points, reference_keyframe_id: int, last_frame_T, motion_model,
                       last_keyframe_frame_id: int, last_frame_id: int, gauge_log=()) -> Map:
    """Continue the port's ``SLAM`` facade from a snapshot of the JAX
    facade's state, taken as numpy arrays: the map (``map_from_numpy``'s
    keyframes and landmarks, descriptors and ids), the reference keyframe's
    id, the last frame's pose and id, the motion model, the frame id of the
    last keyframe and the gauge log ((s, b) per recorded similarity, so
    ``gauge_version`` matches). The copy replaces the map in every component
    that holds it; state becomes OK and the id counters move past the
    copied ids. Returns the installed map."""
    from .map.frame import FrameBase
    from .state import State

    m = map_from_numpy(keyframes, points, device=slam.device)
    m._gauge_log = [(float(s), np.asarray(b, np.float64).reshape(3)) for s, b in gauge_log]
    for owner in (slam, slam.tracking, slam.tracking.initializer, slam.local_mapping, slam.local_mapping.handler,
                  slam.local_handler, slam.global_handler, slam.loop_closing):
        if owner is not None:
            owner.map = m
    _advance_ids(KeyFrame, "_kf_ids", max(k.keyframe_id for k in m.get_keyframes()) + 1)
    _advance_ids(MapPoint, "_ids", max((p.id for p in m.get_map_points()), default=-1) + 1)
    _advance_ids(FrameBase, "_ids", max([k.id for k in m.get_keyframes()] + [int(last_frame_id)]) + 1)
    tr = slam.tracking
    tr.reference_keyframe = m.get_keyframe_by_id(int(reference_keyframe_id))
    tr.last_frame = tr.current_frame = Frame(pose=Pose(_np(last_frame_T)), frame_id=int(last_frame_id))
    tr.motion_model = np.array(_np(motion_model), np.float64)
    tr.last_keyframe_frame_id = int(last_keyframe_frame_id)
    tr._gauge_seen = tr._gather_gauge_version = m.gauge_version
    tr.initializer.initialized = True
    slam.state = State.OK
    return m
