"""Map container: frames ring, keyframe list, landmark set
(port of ``visual_slam_tpu.map.map``).

Add/remove/get for frames, keyframes and points, the landmark budget, mean
reprojection error, and the ``optimize_*`` entry points, which delegate to
an optimizer object. One coarse lock guards container mutation; heavy
compute runs outside it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .frame import Frame
from .keyframe import KeyFrame
from .map_point import MapPoint


class Map:
    def __init__(self, max_frames: int = 5):
        self._lock = threading.RLock()
        self._frames: Deque[Frame] = deque(maxlen=max_frames)
        self._keyframes: List[KeyFrame] = []
        self._kf_by_id: Dict[int, KeyFrame] = {}
        # Keyed by landmark id (insertion-ordered): iteration order must be
        # deterministic — a set here would make BA packing order depend on
        # object addresses and results vary run to run.
        self._points: Dict[int, MapPoint] = {}
        # Versioned mono-gauge log. Every global BA re-imposes the mono
        # scale gauge with a similarity x -> s*x + b applied to all keyframe
        # centers and landmarks (backend/optimizer._reimpose_mono_gauge).
        # In threaded mode that lands asynchronously: a tracking thread that
        # solved a pose against pre-renormalization landmarks must convert
        # it through the same similarity before writing it into the map —
        # readers snapshot gauge_version with their landmark gather and
        # catch up via gauge_since() (cures the round-2 "tolerated" race,
        # tests/test_slam_e2e.py::test_threaded_mode_e2e).
        self._gauge_log: List[tuple] = []  # (s, b): x -> s * x + b

    # -- frames ------------------------------------------------------------
    def add_frame(self, frame: Frame) -> None:
        with self._lock:
            self._frames.append(frame)

    def get_frames(self) -> List[Frame]:
        with self._lock:
            return list(self._frames)

    def get_last_frame(self) -> Optional[Frame]:
        with self._lock:
            return self._frames[-1] if self._frames else None

    def num_frames(self) -> int:
        with self._lock:
            return len(self._frames)

    # -- keyframes ---------------------------------------------------------
    def add_keyframe(self, kf: KeyFrame) -> None:
        with self._lock:
            self._keyframes.append(kf)
            self._kf_by_id[kf.keyframe_id] = kf

    def remove_keyframe(self, kf: KeyFrame) -> None:
        with self._lock:
            if kf in self._keyframes:
                self._keyframes.remove(kf)
            self._kf_by_id.pop(kf.keyframe_id, None)
            for (cam_id, kp_idx) in list(kf.map_points.keys()):
                kf.remove_map_point(cam_id, kp_idx)

    def get_keyframe_by_id(self, kf_id: int) -> Optional[KeyFrame]:
        with self._lock:
            return self._kf_by_id.get(kf_id)

    def get_keyframes(self) -> List[KeyFrame]:
        with self._lock:
            return list(self._keyframes)

    def get_last_keyframe(self) -> Optional[KeyFrame]:
        with self._lock:
            return self._keyframes[-1] if self._keyframes else None

    def num_keyframes(self) -> int:
        with self._lock:
            return len(self._keyframes)

    # -- landmarks ---------------------------------------------------------
    def add_map_point(self, mp: MapPoint) -> None:
        with self._lock:
            self._points[mp.id] = mp

    def remove_map_point(self, mp: MapPoint) -> None:
        # O(observations) via the landmark's back-links (not an O(KFs x
        # points) scan): each observation names exactly the (kf, cam, kp)
        # slot holding this landmark.
        with self._lock:
            self._points.pop(mp.id, None)
            mp.set_bad()
            for kf_id, cam_id, kp_idx in list(mp.observations.items()):
                kf = self._kf_by_id.get(kf_id)
                if kf is not None and kf.map_points.get((cam_id, kp_idx)) is mp:
                    del kf.map_points[(cam_id, kp_idx)]
            # Stale links can exist only if a keyframe was never registered
            # with the map (e.g. pre-insertion init keyframes) — those clean
            # themselves up when the keyframe is dropped.

    def fuse_map_points(self, keep: MapPoint, drop: MapPoint) -> int:
        """Merge two landmarks observed as the same physical point (the
        ORB-SLAM local-mapping Fuse step): transfer ``drop``'s observations to
        ``keep`` where keep has none in that (keyframe, camera), rebinding
        the keypoint slots; then retire ``drop``. Returns the number of
        observations transferred."""
        moved = 0
        with self._lock:
            if keep is drop:
                return 0
            for kf_id, cam_id, kp_idx in list(drop.observations.items()):
                kf = self._kf_by_id.get(kf_id)
                if kf is None or kf.map_points.get((cam_id, kp_idx)) is not drop:
                    continue
                if keep.observations.get(kf_id, cam_id) is None:
                    kf.map_points[(cam_id, kp_idx)] = keep
                    keep.add_observation(kf_id, cam_id, kp_idx)
                    moved += 1
                else:
                    del kf.map_points[(cam_id, kp_idx)]
            self._points.pop(drop.id, None)
            drop.set_bad()
        return moved

    def evict_landmarks(self, budget: int, protect_recent: int = 8) -> int:
        """Enforce a hard landmark budget by evicting the least-recently-
        observed points first (LRU by newest observing keyframe id, then
        fewest observations). Landmarks observed by any of the last
        ``protect_recent`` keyframes are never evicted: the tracking front
        end (host reference block AND the device guided-matching arena) is
        built from exactly those, and evicting a just-triangulated landmark
        would thin the live reference the next chunk tracks against.

        A fixed budget keeps every BA pack inside one shape bucket.

        Returns the number of landmarks evicted (0 if within budget, or if
        the protected set alone exceeds the budget — the BA pack's
        ``max_points`` cap is the backstop for that transient)."""
        with self._lock:
            mps = [mp for mp in self._points.values() if not mp.is_bad]
            excess = len(mps) - budget
            if excess <= 0:
                return 0
            recent = {
                kf.keyframe_id for kf in self._keyframes[-protect_recent:]
            }

            def key(mp):
                ids = mp.observations.get_keyframe_ids()
                return (max(ids) if ids else -1, mp.num_observations(), mp.id)

            evictable = sorted(
                (
                    mp
                    for mp in mps
                    if not any(
                        kf_id in recent
                        for kf_id in mp.observations.get_keyframe_ids()
                    )
                ),
                key=key,
            )
            n = 0
            for mp in evictable[:excess]:
                self.remove_map_point(mp)
                n += 1
            return n

    def get_map_points(self) -> List[MapPoint]:
        with self._lock:
            return list(self._points.values())

    def num_map_points(self) -> int:
        with self._lock:
            return len(self._points)

    # -- metrics -----------------------------------------------------------
    def compute_mean_reprojection_error(self, K: np.ndarray) -> float:
        with self._lock:
            kfs = list(self._keyframes)
        errs = []
        for kf in kfs:
            pts, uvs = [], []
            kps = kf.keypoints(0)
            for (cam_id, kp_idx), mp in list(kf.map_points.items()):
                if cam_id != 0 or mp.is_bad:
                    continue
                pts.append(mp.position)
                uvs.append(kps[kp_idx])
            if not pts:
                continue
            uv_proj, z = kf.project_points(K, np.asarray(pts))
            ok = z > 1e-6
            if ok.any():
                errs.extend(np.linalg.norm(uv_proj[ok] - np.asarray(uvs)[ok], axis=-1).tolist())
        return float(np.mean(errs)) if errs else 0.0

    # -- optimization entry points -----------------------------------------
    def optimize_initial(self, optimizer, keyframes=None) -> dict:
        kfs = keyframes if keyframes is not None else self.get_keyframes()[-2:]
        return optimizer.optimize_initial(kfs)

    def optimize_local(self, optimizer, keyframes=None) -> dict:
        kfs = keyframes if keyframes is not None else self.get_keyframes()
        # Dedupe landmarks across the window.
        points = {}
        for kf in kfs:
            for mp in list(kf.map_points.values()):
                if not mp.is_bad:
                    points[mp.id] = mp
        # Out-of-window keyframes observing window landmarks join as fixed
        # anchors so landmark updates cannot degrade the rest of the map.
        window_ids = {kf.keyframe_id for kf in kfs}
        anchor_ids = set()
        for mp in points.values():
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id not in window_ids:
                    anchor_ids.add(kf_id)
        anchors = [kf for kf in self.get_keyframes() if kf.keyframe_id in anchor_ids]
        return optimizer.optimize_local(kfs, list(points.values()), fixed_keyframes=anchors)

    def optimize_global(self, optimizer) -> dict:
        res = optimizer.optimize_global(self.get_keyframes(), self.get_map_points())
        g = res.get("gauge_transform") if isinstance(res, dict) else None
        if g is not None:
            self.record_gauge_transform(*g)
        return res

    # -- versioned mono gauge (see __init__ notes) -------------------------
    @property
    def gauge_version(self) -> int:
        return len(self._gauge_log)

    def record_gauge_transform(self, s: float, b) -> None:
        """Append a similarity x -> s*x + b that was just applied to every
        keyframe center and landmark. Called under the optimize lock, AFTER
        the writeback, so version-then-data reads can detect torn gathers."""
        with self._lock:
            self._gauge_log.append((float(s), np.asarray(b, np.float64).reshape(3)))

    def gauge_since(self, version: int) -> tuple:
        """Compose every gauge similarity applied after ``version`` into one
        (s, b). Identity when nothing happened."""
        with self._lock:
            s, b = 1.0, np.zeros(3)
            for si, bi in self._gauge_log[version:]:
                s, b = si * s, si * b + bi
            return s, b

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._frames.clear()
            self._keyframes.clear()
            self._kf_by_id.clear()
            self._points.clear()
            self._gauge_log.clear()
