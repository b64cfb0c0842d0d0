"""Global bundle-adjustment handler (port of
``visual_slam_tpu.handlers.global_handler``): full-map BA over every
keyframe (``Map.optimize_global``, which records the mono gauge
similarity), meant to run rarely, after a loop closure or on demand, on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from ..map import Map
from ..utils.device import default_device
from .base_handler import BaseHandler


class GlobalHandler(BaseHandler):
    def __init__(self, slam_map: Map, optimizer, camera, config, device=None, **kwargs):
        super().__init__(run_timeout=1.0, **kwargs)
        self.device = default_device(device)
        if optimizer is None:
            from ..backend.optimizer import LMOptimizer

            optimizer = LMOptimizer(config, camera, logger=self.logger, device=self.device)
        self.map = slam_map
        self.optimizer = optimizer
        self.camera = camera
        self.config = config
        self.last_result: dict = {}

    def step(self) -> None:
        if self.map.num_keyframes() < 3:
            return
        err_before = self.map.compute_mean_reprojection_error(self.camera.K)
        with self.map._lock:  # one consistent pack, solve and writeback
            result = self.map.optimize_global(self.optimizer)
        err_after = self.map.compute_mean_reprojection_error(self.camera.K)
        result["reproj_before_px"] = err_before
        result["reproj_after_px"] = err_after
        self.last_result = result
        self.logger.info("global BA over %d KFs: reproj %.3fpx -> %.3fpx", self.map.num_keyframes(), err_before,
                         err_after)
