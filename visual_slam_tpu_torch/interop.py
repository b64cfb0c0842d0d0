"""Carry tracking state and maps across from the JAX package, as numpy arrays.

The system has no weights: what carries over is the state (reference
features, landmarks, poses, the arena, the map) and the constants, which
the port builds from the same seeds. Descriptor words are ``uint32`` in the
JAX package and ``int32`` here, bit for bit (``ndarray.view``). Nothing here
imports JAX: the arguments are any objects with the JAX fields, holding
numpy arrays, anything ``np.asarray`` reads, or the port's own tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .map import KeyFrame, Map, MapPoint
from .map.pose import Pose
from .ops.detector import Features
from .pipeline import TrackState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def desc_to_int32(desc) -> np.ndarray:
    """uint32 descriptor words (or the port's int32 words) -> int32 bits."""
    return np.ascontiguousarray(_np(desc)).view(np.int32)


def desc_to_uint32(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptor words -> the JAX package's uint32 bits."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def features_from_numpy(feats, device=None) -> Features:
    """The port's ``Features`` on ``device`` from an object with the JAX
    ``Features`` fields."""

    def t(x, dtype):
        return torch.tensor(_np(x), dtype=dtype).to(device)

    return Features(
        xy=t(feats.xy, torch.float32),
        response=t(feats.response, torch.float32),
        angle=t(feats.angle, torch.float32),
        octave=t(feats.octave, torch.int32),
        size=t(feats.size, torch.float32),
        desc=torch.from_numpy(desc_to_int32(feats.desc)).to(device),
        valid=t(feats.valid, torch.bool),
    )


def track_state_from_numpy(state, device=None, seed: int = 0) -> TrackState:
    """The port's ``TrackState`` on ``device`` from the leaves of a JAX
    ``TrackState``. The JAX PRNG key does not carry over: RANSAC draws come
    from a new generator seeded with ``seed``."""

    def t(x, dtype):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dtype).to(device)

    device = torch.device(device) if device is not None else torch.device("cpu")
    return TrackState(
        ref_feats=features_from_numpy(state.ref_feats, device),
        ref_landmarks=t(state.ref_landmarks, torch.float32),
        ref_has_landmark=t(state.ref_has_landmark, torch.bool),
        T_w2c=t(state.T_w2c, torch.float32),
        T_rel=t(state.T_rel, torch.float32),
        gen=torch.Generator(device=device).manual_seed(seed),
        lm_pos=t(state.lm_pos, torch.float32),
        lm_desc=None if state.lm_desc is None else torch.from_numpy(desc_to_int32(state.lm_desc)).to(device),
        lm_valid=t(state.lm_valid, torch.bool),
    )


def keyframe_from_numpy(features, T_w2c, keyframe_id: int, frame_id: int | None = None,
                        timestamp: float = 0.0, device=None) -> KeyFrame:
    """The port's ``KeyFrame`` with the given ids and pose, its feature
    blocks (one per camera, objects with the JAX ``Features`` fields) on
    ``device``. A copy takes no new keyframe id from the class counter
    (nor a frame id, when ``frame_id`` is given): loop closing's cooldown
    reads the gaps between ids."""
    return KeyFrame(features=[features_from_numpy(f, device) for f in features], timestamp=timestamp,
                    pose=Pose(_np(T_w2c)), frame_id=frame_id, keyframe_id=keyframe_id)


def map_from_numpy(keyframes, points, device=None) -> Map:
    """The port's ``Map`` holding the same keyframes and landmarks as a JAX
    ``Map`` (``map_from_numpy(m.get_keyframes(), m.get_map_points())``), or
    as any objects with their fields: keyframes with ``keyframe_id``, ``id``,
    ``timestamp``, ``T_w2c``, ``features`` and ``map_points`` ({(cam, kp):
    point}); points with ``id``, ``position``, ``is_bad`` and
    ``observations.items()`` ((kf_id, cam, kp) triples). Ids, insertion
    order, observations and keyframe links are kept, so host bookkeeping
    iterates in the same order in both packages."""
    m = Map()
    for src in keyframes:
        m.add_keyframe(keyframe_from_numpy(src.features, src.T_w2c, src.keyframe_id, frame_id=src.id,
                                           timestamp=src.timestamp, device=device))
    by_id = {}
    for src in points:
        mp = MapPoint(_np(src.position))
        mp.id = int(src.id)
        mp.is_bad = bool(src.is_bad)
        for kf_id, cam_id, kp_idx in src.observations.items():
            mp.add_observation(int(kf_id), int(cam_id), int(kp_idx))
        by_id[mp.id] = mp
        m.add_map_point(mp)
    for src in keyframes:
        kf = m.get_keyframe_by_id(int(src.keyframe_id))
        for (cam_id, kp_idx), smp in src.map_points.items():
            kf.map_points[(int(cam_id), int(kp_idx))] = by_id[int(smp.id)]
    return m
