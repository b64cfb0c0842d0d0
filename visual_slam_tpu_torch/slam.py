"""The host SLAM facade: wiring and lifecycle (port of ``visual_slam_tpu.slam``)
for monocular, stereo and RGB-D cameras.

``SLAM(camera, config, device=...)`` builds the ``FeatureTracker``, ``Map``,
``LMOptimizer``, ``LocalMapping``, ``Tracking``, the local and global BA
handlers and, with ``loop_closing.enabled``, ``LoopClosing``, all on
``device`` (the card unless the caller passes ``device="cpu"``; without a
card ``None`` raises). ``track(images, timestamp, depth=None)`` runs one
frame (``[left, right]`` for stereo, a depth map in ``depth`` for RGB-D):
on a new keyframe the local BA handler steps and loop closing looks for a
revisit (kernel K4). By default local mapping and BA run inline at
keyframe boundaries; ``threaded=True`` runs them on background threads
under the map lock, as in the JAX package.

``save(path)`` checkpoints the map and the tracking context in the JAX
package's format; ``SLAM.resume(path, camera, device=...)`` goes on from a
checkpoint of either package. ``optimization.solver="adam"`` builds the
``AdamOptimizer`` (``backend/adam.py``) in place of the ``LMOptimizer``, as
the JAX package does; ``CompiledSLAM`` and ``PipelinedVO`` keep the LM
whatever ``solver`` says, as the JAX package's do.
"""
from __future__ import annotations

import json

import numpy as np

from .backend.optimizer import LMOptimizer
from .camera import Camera
from .config import Config
from .frontend.tracker import FeatureTracker
from .handlers import GlobalHandler, LocalHandler
from .local_mapping import LocalMapping
from .map import Map
from .sensor_type import SensorType
from .state import State
from .tracking import Tracking
from .utils.device import default_device
from .utils.logging import get_logger


class SLAM:
    def __init__(self, camera: Camera, config: Config | None = None, log_dir: str | None = None,
                 threaded: bool = False, device=None):
        self.camera = camera
        self.config = config or Config()
        self.device = default_device(device)
        self.state = State.NO_IMAGES_YET
        self.logger = get_logger("slam", log_dir=log_dir)
        if self.config.feature.ragged_descriptors:
            raise NotImplementedError("ragged descriptors are not ported: they exist for the TPU's tiling")

        dev = self.device
        self.feature_tracker = FeatureTracker(self.config.feature, device=dev)
        self.map = Map(max_frames=self.config.map.max_frames)
        if self.config.optimization.solver == "adam":
            from .backend.adam import AdamOptimizer

            self.optimizer = AdamOptimizer(self.config, camera, logger=get_logger("optimizer", log_dir), device=dev)
        else:
            self.optimizer = LMOptimizer(self.config, camera, logger=get_logger("optimizer", log_dir), device=dev)
        sensor = SensorType[self.config.camera.sensor_type.upper()]
        self.local_mapping = LocalMapping(camera, self.config, self.map, self.feature_tracker, sensor_type=sensor,
                                          logger=get_logger("local_mapping", log_dir), threaded=threaded, device=dev)
        self.tracking = Tracking(camera, self.config, self.feature_tracker, self.map, self.local_mapping,
                                 optimizer=self.optimizer, logger=get_logger("tracking", log_dir), slam=self,
                                 device=dev)
        self.local_handler = LocalHandler(self.map, self.optimizer, camera, self.config, device=dev, threaded=threaded,
                                          logger=get_logger("local_handler", log_dir))
        self.global_handler = GlobalHandler(self.map, self.optimizer, camera, self.config, device=dev,
                                            threaded=threaded, logger=get_logger("global_handler", log_dir))
        if self.config.loop_closing.enabled:
            from .loop_closing import LoopClosing

            self.loop_closing = LoopClosing(self.map, camera, self.config, optimizer=self.optimizer,
                                            logger=get_logger("loop_closing", log_dir))
        else:
            self.loop_closing = None
        self.threaded = threaded
        self._post_start()

    def _post_start(self) -> None:
        if self.threaded:
            # Every thread launches on the default stream (see the threads'
            # start methods): no per-thread streams.
            self.local_mapping.start()
            self.local_handler.start()
            self.global_handler.start()

    # -- main API ------------------------------------------------------------
    def track(self, images, timestamp: float, depth=None) -> dict:
        info = self.tracking.track(images, timestamp, depth)
        if info.get("new_keyframe"):
            # Windowed BA at keyframe boundaries.
            self.local_handler.trigger()
            if self.loop_closing is not None:
                kf = self.map.get_last_keyframe()
                if kf is not None:
                    loop = self.loop_closing.process_keyframe(kf)
                    if loop is not None:
                        info["loop_closed"] = loop["loop"]
        return info

    def shutdown(self) -> None:
        if self.threaded:
            self.local_mapping.stop()
            self.local_handler.stop()
            self.global_handler.stop()
            self.local_mapping.join(2.0)
            self.local_handler.join(2.0)
            self.global_handler.join(2.0)
        self.local_mapping.drain()
        if self.threaded and self.map.num_keyframes() >= 2:
            # One clean full-map BA on the quiesced map consolidates what the
            # threads left (a solve stopped midway, a stale writeback).
            self.optimizer.optimize_global(self.map.get_keyframes(), self.map.get_map_points())
        self.logger.info("shutdown: %d keyframes, %d landmarks", self.map.num_keyframes(), self.map.num_map_points())

    def reset(self) -> None:
        self.map.reset()
        self.state = State.NO_IMAGES_YET
        self.tracking.last_frame = None
        self.tracking.current_frame = None
        self.tracking.reference_keyframe = None
        self.tracking.initializer.initialized = False

    # -- checkpoint / resume ---------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint into directory ``path``: the map (``map.npz``) and the
        tracking context and config (``slam.json``), in the JAX package's
        format."""
        from pathlib import Path

        from .utils.serialization import save_map

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        save_map(self.map, path / "map.npz")
        meta = {
            "state": self.state.name,
            "motion_model": np.asarray(self.tracking.motion_model).tolist(),
            "last_keyframe_frame_id": self.tracking.last_keyframe_frame_id,
            "config": self.config.to_dict(),
        }
        (path / "slam.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def resume(cls, path, camera, log_dir: str | None = None, device=None) -> "SLAM":
        """A system restored from a checkpoint of either package on
        ``device`` (the card unless named): tracking, local mapping, both
        handlers and loop closing work on the restored map, and tracking goes
        on from its last keyframe with the saved motion model."""
        from pathlib import Path

        from .utils.serialization import load_map

        path = Path(path)
        meta = json.loads((path / "slam.json").read_text())
        slam = cls(camera, Config.from_dict(meta["config"]), log_dir=log_dir, device=device)
        slam.map = load_map(path / "map.npz", device=slam.device)
        for owner in (slam.tracking, slam.tracking.initializer, slam.local_mapping, slam.local_mapping.handler,
                      slam.local_handler, slam.global_handler, slam.loop_closing):
            if owner is not None:
                owner.map = slam.map
        kf = slam.map.get_last_keyframe()
        if kf is not None and meta["state"] in ("OK", "MAPPING"):
            slam.state = State.OK
            tr = slam.tracking
            tr.reference_keyframe = tr.last_frame = tr.current_frame = kf
            tr.last_keyframe_frame_id = meta["last_keyframe_frame_id"]
            tr.motion_model = np.asarray(meta["motion_model"], np.float64)
            tr.initializer.initialized = True
        return slam

    # -- introspection ---------------------------------------------------------
    def metrics(self) -> dict:
        """Observability snapshot for dashboards and tests."""
        return {
            "state": self.state.name,
            "num_keyframes": self.map.num_keyframes(),
            "num_map_points": self.map.num_map_points(),
            "num_frames_buffered": self.map.num_frames(),
            "mean_reprojection_error_px": self.map.compute_mean_reprojection_error(self.camera.K),
            "last_track": {k: v for k, v in self.tracking.last_track_info.items()
                           if isinstance(v, (int, float, bool, str))},
            "last_ba": {k: v for k, v in self.local_handler.last_result.items()
                        if isinstance(v, (int, float, bool, str))},
            "loops_closed": len(self.loop_closing.closed_loops) if self.loop_closing is not None else 0,
        }

    def trajectory(self):
        """(frame_id, timestamp, T_w2c (4, 4)) per keyframe, in order."""
        return [(kf.id, kf.timestamp, np.asarray(kf.T_w2c)) for kf in self.map.get_keyframes()]
