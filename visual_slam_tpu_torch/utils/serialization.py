"""Map, trajectory and tracking-state serialization: checkpoint and resume
(port of ``visual_slam_tpu.utils.serialization``, in the same file format).

A map is one compressed ``.npz`` with the JAX package's keys, shapes and
dtypes, so a map saved by either package loads in the other. Descriptor
words are ``uint32`` on disk (the JAX package's type) and ``int32`` views
in the port, bit for bit. ``load_map(path, device=...)`` places every
keyframe's feature block on ``device`` (the card unless the caller names
one; without a card ``None`` raises) and fills its host views from the file,
so reading them costs no device copy. Trajectories export in the TUM and
KITTI text formats.
"""
from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np
import torch

from .device import default_device
from .tree import as_numpy

_FEATURE_KEYS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _uint32(words) -> np.ndarray:
    """Descriptor words as ``uint32`` bits (from the port's int32 words, or
    any integer array)."""
    a = np.ascontiguousarray(as_numpy(words))
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _stack_descs(mps) -> np.ndarray:
    """Landmark descriptor table (uint32 words, a zeros row where a landmark
    has none) at the width of the first descriptor found (8 words for the
    binary families)."""
    width = next((int(np.asarray(mp.descriptor).size) for mp in mps if mp.descriptor is not None), 8)
    out = np.zeros((len(mps), width), np.uint32)
    for r, mp in enumerate(mps):
        if mp.descriptor is not None:
            d = _uint32(mp.descriptor).reshape(-1)[:width]
            out[r, :d.shape[0]] = d
    return out


def save_map(slam_map, path: str | Path) -> None:
    """Keyframes (ids, poses, timestamps, feature blocks), live landmarks
    (positions, colours, descriptors) and the observation table
    (keyframe row, camera, keypoint, landmark row) into one ``.npz``."""
    kfs = slam_map.get_keyframes()
    mps = [mp for mp in slam_map.get_map_points() if not mp.is_bad]
    mp_index = {id(mp): i for i, mp in enumerate(mps)}
    obs = [(r, cam_id, kp_idx, mp_index[id(mp)])
           for r, kf in enumerate(kfs) for (cam_id, kp_idx), mp in list(kf.map_points.items()) if id(mp) in mp_index]
    data = {
        "n_keyframes": np.asarray(len(kfs)),
        "kf_ids": np.asarray([kf.keyframe_id for kf in kfs], np.int64),
        "kf_frame_ids": np.asarray([kf.id for kf in kfs], np.int64),
        "kf_timestamps": np.asarray([kf.timestamp for kf in kfs], np.float64),
        "kf_poses": np.stack([kf.T_w2c for kf in kfs]) if kfs else np.zeros((0, 4, 4)),
        "mp_positions": np.stack([mp.position for mp in mps]) if mps else np.zeros((0, 3)),
        "mp_colors": np.stack([mp.color for mp in mps]) if mps else np.zeros((0, 3), np.uint8),
        "mp_descs": _stack_descs(mps),
        "observations": np.asarray(obs, np.int64).reshape(-1, 4),
    }
    for r, kf in enumerate(kfs):
        f = kf.get_features(0)
        if f is None:
            continue
        host = {key: as_numpy(getattr(f, key)) for key in _FEATURE_KEYS}
        host["desc"] = _uint32(host["desc"])
        for key, a in host.items():
            data[f"kf{r}_{key}"] = a
    np.savez_compressed(path, **data)


def _advance_ids(owner, attr: str, lock, nxt: int) -> None:
    with lock:
        setattr(owner, attr, itertools.count(max(next(getattr(owner, attr)), nxt)))


def load_map(path: str | Path, device=None):
    """Rebuild a ``Map`` (keyframes, landmarks, observation links) from a
    ``.npz`` written by either package, with every keyframe's features on
    ``device``. Keyframes keep their saved frame and keyframe ids, and the
    id counters move past the restored maxima: tracking's keyframe gap
    compares new frame ids with the restored keyframes', so counters that
    restarted at 0 in a new process would hold back keyframes after resume.
    A file that is missing, not a map or damaged raises."""
    from ..map import KeyFrame, Map, MapPoint
    from ..map.frame import FrameBase
    from ..map.pose import Pose
    from ..ops.detector import Features

    device = default_device(device)
    dtypes = {"xy": torch.float32, "response": torch.float32, "angle": torch.float32, "octave": torch.int32,
              "size": torch.float32, "desc": torch.int32, "valid": torch.bool}
    with np.load(path) as z:
        n = int(z["n_keyframes"])
        slam_map = Map()
        kfs = []
        for r in range(n):
            feats = []
            if f"kf{r}_xy" in z:
                host = {key: np.asarray(z[f"kf{r}_{key}"]) for key in _FEATURE_KEYS}
                host["desc"] = np.ascontiguousarray(host["desc"].astype(np.uint32, copy=False)).view(np.int32)
                feats = [Features(*[torch.from_numpy(np.ascontiguousarray(host[key])).to(dtypes[key]).to(device)
                                    for key in _FEATURE_KEYS])]
            kf = KeyFrame(features=feats, timestamp=float(z["kf_timestamps"][r]), pose=Pose(z["kf_poses"][r]),
                          frame_id=int(z["kf_frame_ids"][r]), keyframe_id=int(z["kf_ids"][r]))
            if feats:
                kf.cache_host_features(Features(*[host[key] for key in _FEATURE_KEYS]))
            slam_map.add_keyframe(kf)
            kfs.append(kf)
        if n:
            _advance_ids(FrameBase, "_ids", FrameBase._ids_lock, int(z["kf_frame_ids"].max()) + 1)
            _advance_ids(KeyFrame, "_kf_ids", KeyFrame._kf_ids_lock, int(z["kf_ids"].max()) + 1)
        descs = np.asarray(z["mp_descs"]).astype(np.uint32, copy=False) if "mp_descs" in z else None
        mps = []
        for i, (pos, color) in enumerate(zip(z["mp_positions"], z["mp_colors"])):
            mp = MapPoint(pos, color=color)
            if descs is not None and descs[i].any():
                mp.descriptor = descs[i].copy().view(np.int32)
            slam_map.add_map_point(mp)
            mps.append(mp)
        for kf_row, cam_id, kp_idx, mp_row in z["observations"]:
            kfs[int(kf_row)].add_map_point(int(cam_id), int(kp_idx), mps[int(mp_row)])
    return slam_map


def save_trajectory_tum(keyframes, path: str | Path) -> None:
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` (camera to world)."""
    lines = []
    for kf in keyframes:
        t = np.linalg.inv(kf.T_w2c)[:3, 3]
        q = kf.pose.inverse().quaternion()  # (w, x, y, z)
        lines.append(f"{kf.timestamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    Path(path).write_text("\n".join(lines) + "\n")


def save_trajectory_kitti(keyframes, path: str | Path) -> None:
    """KITTI format: the 12 row-major entries of T_c2w[:3] per line."""
    lines = [" ".join(f"{v:.6e}" for v in np.linalg.inv(kf.T_w2c)[:3].reshape(-1)) for kf in keyframes]
    Path(path).write_text("\n".join(lines) + "\n")


def load_trajectory_tum(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (N,), T_c2w (N, 4, 4))."""
    rows = np.loadtxt(str(path)).reshape(-1, 8)
    Ts = np.tile(np.eye(4), (len(rows), 1, 1))
    for i, (tx, ty, tz, qx, qy, qz, qw) in enumerate(rows[:, 1:]):
        qw, qx, qy, qz = np.array([qw, qx, qy, qz]) / np.linalg.norm([qw, qx, qy, qz])
        Ts[i, :3, :3] = [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
        Ts[i, :3, 3] = (tx, ty, tz)
    return rows[:, 0], Ts


def save_track_state(state, path: str | Path) -> None:
    """Checkpoint one sequence's ``TrackState`` in the JAX package's leaf
    order (the seven feature fields, the reference landmarks and mask, the
    pose, the motion model, the PRNG key, then the arena where there is
    one), descriptors as ``uint32``. The key slot holds the generator's seed
    in the layout of ``jax.random.PRNGKey`` (high and low 32-bit words); the
    draw position within the stream is not saved."""
    seed = int(state.gen.initial_seed())
    key = np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)
    feats = [as_numpy(getattr(state.ref_feats, k)) for k in _FEATURE_KEYS]
    feats[5] = _uint32(feats[5])
    leaves = feats + [as_numpy(state.ref_landmarks), as_numpy(state.ref_has_landmark), as_numpy(state.T_w2c),
                      as_numpy(state.T_rel), key]
    for x, conv in ((state.lm_pos, as_numpy), (state.lm_desc, _uint32), (state.lm_valid, as_numpy)):
        if x is not None:  # JAX's flatten drops a None leaf
            leaves.append(conv(x))
    np.savez_compressed(path, *leaves)


def load_track_state(path: str | Path, device=None):
    """Restore a ``TrackState`` saved by either package on ``device`` (the
    card unless named). RANSAC draws come from a new generator seeded from
    the key slot."""
    from ..interop import track_state_from_numpy
    from ..ops.detector import Features
    from ..pipeline import TrackState

    device = default_device(device)
    with np.load(path) as z:
        arrays = [np.asarray(z[k]) for k in z.files]
    if len(arrays) not in (12, 15):
        raise ValueError(f"{path}: {len(arrays)} arrays, not a tracking state (12, or 15 with the arena)")
    key = arrays[11].astype(np.uint64)
    state = TrackState(Features(*arrays[:7]), *arrays[7:11], None, *arrays[12:])
    return track_state_from_numpy(state, device, seed=int((key[0] << np.uint64(32)) | key[1]))
