"""LocalMapping: the keyframe consumer, synchronous or on a thread (port of
``visual_slam_tpu.local_mapping.local_mapping``).

``insert_keyframe`` processes the keyframe inline (the default) or queues it
for the thread's ``run`` loop (``threaded=True``). Processing, under the map
lock, brings a queued keyframe's pose up to the current mono gauge, runs
the sensor's keyframe handler (neighbour matching and triangulation on
``device``), adds the keyframe, updates covisibility, culls landmarks
without observations, culls redundant keyframes and enforces the landmark
budget. ``make_handler`` picks the sensor's handler: monocular, stereo or
RGB-D.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from ..camera import Camera
from ..config import Config
from ..map import KeyFrame, Map
from ..sensor_type import SensorType
from ..utils.device import default_device
from .base import BaseKeyframeHandler
from .mono import MonoKeyframeHandler
from .rgbd import RGBDKeyframeHandler
from .stereo import StereoKeyframeHandler


def make_handler(sensor_type: SensorType, camera, config, slam_map, tracker, logger=None,
                 device=None) -> BaseKeyframeHandler:
    cls = {
        SensorType.MONOCULAR: MonoKeyframeHandler,
        SensorType.STEREO: StereoKeyframeHandler,
        SensorType.RGBD: RGBDKeyframeHandler,
    }[sensor_type]
    return cls(camera, config, slam_map, tracker, logger, device=device)


class LocalMapping:
    def __init__(
        self,
        camera: Camera,
        config: Config,
        slam_map: Map,
        feature_tracker,
        sensor_type: SensorType = SensorType.MONOCULAR,
        logger: Optional[logging.Logger] = None,
        threaded: bool = False,
        device=None,
    ):
        self.camera = camera
        self.config = config
        self.map = slam_map
        self.device = default_device(device)
        self.logger = logger or logging.getLogger("local_mapping")
        self.handler = make_handler(sensor_type, camera, config, slam_map, feature_tracker, self.logger,
                                    device=self.device)
        self.threaded = threaded
        self._queue: "queue.Queue[KeyFrame]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.covisibility: dict[int, dict[int, int]] = {}  # kf_id -> {kf_id: shared}
        self.failures = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self.threaded and self._thread is None:
            self._stop.clear()
            # The thread launches its matches and triangulations on the
            # default stream, as the tracking thread does: the card
            # serialises them, the map lock keeps the host state consistent.
            self._thread = threading.Thread(target=self.run, daemon=True, name="local_mapping")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- producer side -----------------------------------------------------
    def insert_keyframe(self, kf: KeyFrame) -> None:
        if self.threaded:
            self._queue.put(kf)
        else:
            self.process_keyframe(kf)

    # -- consumer loop -----------------------------------------------------
    def run(self) -> None:
        while not self._stop.is_set():
            try:
                kf = self._queue.get(timeout=self.config.local_mapping.run_timeout)
            except queue.Empty:
                continue
            try:
                self.process_keyframe(kf)
            except Exception:  # pragma: no cover - keep the thread alive, counted
                self.failures += 1
                self.logger.exception("keyframe processing failed")

    def drain(self) -> None:
        """Process any queued keyframes inline (shutdown, tests)."""
        while not self._queue.empty():
            self.process_keyframe(self._queue.get_nowait())

    # -- the work ----------------------------------------------------------
    def process_keyframe(self, kf: KeyFrame) -> dict:
        # Under the map lock: a global BA holds it across its solve and the
        # gauge renormalization, so no landmark is triangulated from poses of
        # one gauge into a map of another.
        with self.map._lock:
            v = getattr(kf, "gauge_version", None)
            if v is not None and v != self.map.gauge_version:
                # A queued keyframe's pose is a gauge behind: convert it first.
                s_g, b_g = self.map.gauge_since(v)
                R = kf.R_w2c
                C = s_g * kf.t_c2w + b_g
                kf.set_pose_Rt(R, -R @ C)
                kf.gauge_version = self.map.gauge_version
            stats = self.handler.process_keyframe(kf)
            self.map.add_keyframe(kf)
            self.update_covisibility(kf)
            self.cull_bad_points()
            mcfg = self.config.map
            if mcfg.cull_redundant_keyframes:
                stats["kf_culled"] = self.cull_redundant_keyframes(protect=kf)
            if mcfg.max_landmarks > 0:
                stats["lm_evicted"] = self.enforce_landmark_budget(mcfg.max_landmarks)
        return stats

    def update_covisibility(self, kf: KeyFrame) -> None:
        """Count the landmarks ``kf`` shares with every other keyframe."""
        counts: dict[int, int] = {}
        for mp in list(kf.map_points.values()):
            if mp.is_bad:
                continue
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id != kf.keyframe_id:
                    counts[kf_id] = counts.get(kf_id, 0) + 1
        self.covisibility[kf.keyframe_id] = counts
        for other_id, c in counts.items():
            self.covisibility.setdefault(other_id, {})[kf.keyframe_id] = c

    def covisible_keyframes(self, kf: KeyFrame, min_shared: int = 15) -> list[int]:
        return [kf_id for kf_id, c in sorted(self.covisibility.get(kf.keyframe_id, {}).items(), key=lambda x: -x[1])
                if c >= min_shared]

    def cull_bad_points(self) -> int:
        """Remove landmarks that are bad or lost every observation."""
        removed = 0
        for mp in self.map.get_map_points():
            if mp.is_bad or mp.num_observations() < 1:
                self.map.remove_map_point(mp)
                removed += 1
        return removed

    def cull_redundant_keyframes(self, protect: KeyFrame | None = None) -> int:
        """A keyframe whose landmarks are mostly observed by >= 3 others is
        redundant. The first (gauge anchor), the newest two and ``protect``
        are never culled."""
        mcfg = self.config.map
        kfs = self.map.get_keyframes()
        if len(kfs) < mcfg.min_keyframes_before_cull:
            return 0
        protected = {kfs[-1].keyframe_id, kfs[-2].keyframe_id}
        if protect is not None:
            protected.add(protect.keyframe_id)
        if kfs:
            protected.add(kfs[0].keyframe_id)
        culled = 0
        for kf in kfs[1:-2]:
            if kf.keyframe_id in protected or kf.is_fixed:
                continue
            mps = [mp for mp in list(kf.map_points.values()) if not mp.is_bad]
            if not mps:
                self.map.remove_keyframe(kf)
                self.covisibility.pop(kf.keyframe_id, None)
                culled += 1
                continue
            redundant = sum(1 for mp in mps if mp.num_observations() >= 4)
            if redundant / len(mps) >= mcfg.kf_redundancy_threshold:
                self.map.remove_keyframe(kf)
                self.covisibility.pop(kf.keyframe_id, None)
                culled += 1
        if culled:
            self.logger.debug("culled %d redundant keyframes", culled)
        return culled

    def enforce_landmark_budget(self, budget: int) -> int:
        """Evict landmarks beyond the budget (``Map.evict_landmarks``: least
        recently observed first, the last ``budget_protect_recent``
        keyframes' landmarks protected)."""
        return self.map.evict_landmarks(budget, protect_recent=getattr(self.config.map, "budget_protect_recent", 8))
