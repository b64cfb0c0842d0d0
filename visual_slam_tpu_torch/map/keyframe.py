"""KeyFrame: a Frame promoted into the map with landmark links
(port of ``visual_slam_tpu.map.keyframe``).

A separate keyframe-id counter, ``map_points`` keyed by (cam_id, kp_idx),
add/get/remove maintaining the MapPoint's back-observations, is_bad and
is_fixed. ``from_frame`` keeps the source frame id and shares the feature
block instead of copying it (it is immutable). A keyframe built with a
``keyframe_id`` (a copy of a map) takes none from the counter: loop
closing's cooldown reads the gaps between ids.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, Tuple

import numpy as np

from .frame import Frame
from .map_point import MapPoint


class KeyFrame(Frame):
    _kf_ids = itertools.count(0)
    _kf_ids_lock = threading.Lock()

    def __init__(self, *args, keyframe_id: int | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        if keyframe_id is None:
            with KeyFrame._kf_ids_lock:
                keyframe_id = next(KeyFrame._kf_ids)
        self.keyframe_id = int(keyframe_id)
        self.map_points: Dict[Tuple[int, int], MapPoint] = {}
        self.is_bad = False
        self.is_fixed = False

    @classmethod
    def from_frame(cls, frame: Frame) -> "KeyFrame":
        # Share the Frame data and keep its id (see module docstring). The
        # constructor still draws one frame id, as the reference's does: the
        # tracker's keyframe gap counts frame ids.
        kf = cls(
            images=frame.images,
            images_gray=frame.images_gray,
            features=frame.features,
            timestamp=frame.timestamp,
            depth=frame.depth,
            pose=frame.pose,
        )
        kf.id = frame.id
        kf.kp_z = frame.kp_z
        kf.kp_z_valid = frame.kp_z_valid
        kf._np_cache = frame._np_cache  # shared immutable feature views
        return kf

    # -- landmark links ----------------------------------------------------
    def add_map_point(self, cam_id: int, kp_idx: int, mp: MapPoint) -> None:
        # One slot per landmark per (keyframe, camera): Observations keeps a
        # single kp_idx per (kf, cam), so a second slot would leave a stale
        # map_points entry that observation-indexed removal can never clean
        # (and that blocks fresh landmark creation at that slot).
        prev_idx = mp.observations.get(self.keyframe_id, cam_id)
        if (
            prev_idx is not None
            and prev_idx != kp_idx
            and self.map_points.get((cam_id, prev_idx)) is mp
        ):
            del self.map_points[(cam_id, prev_idx)]
        self.map_points[(cam_id, kp_idx)] = mp
        mp.add_observation(self.keyframe_id, cam_id, kp_idx)

    def get_map_point(self, cam_id: int, kp_idx: int) -> MapPoint | None:
        return self.map_points.get((cam_id, kp_idx))

    def remove_map_point(self, cam_id: int, kp_idx: int) -> None:
        mp = self.map_points.pop((cam_id, kp_idx), None)
        if mp is not None:
            mp.remove_observation(self.keyframe_id, cam_id)

    def num_map_points(self) -> int:
        return len(self.map_points)

    # -- dense views for device stages -------------------------------------
    def point_arrays(self, cam_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Dense (K, 3) landmark positions + (K,) mask aligned to keypoint
        slots: the array view PnP consumes."""
        K = self.features[cam_id].xy.shape[0]
        pos = np.zeros((K, 3), np.float32)
        mask = np.zeros((K,), bool)
        # list(): GIL-atomic snapshot — the threaded mapping thread may
        # be adding landmarks while tracking reads this view.
        for (cid, kp_idx), mp in list(self.map_points.items()):
            if cid == cam_id and not mp.is_bad and kp_idx < K:
                pos[kp_idx] = mp.position
                mask[kp_idx] = True
        return pos, mask
