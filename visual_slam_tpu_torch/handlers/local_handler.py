"""Local (windowed) bundle-adjustment handler (port of
``visual_slam_tpu.handlers.local_handler``).

Each step runs full-map BA while the map fits a couple of windows and a
sliding-window BA with fixed out-of-window anchors beyond, through the
optimizer's dense LM/Schur solve on ``device`` (the card unless the caller
asks for the CPU), and logs the reprojection error before and after.
"""
from __future__ import annotations

from ..map import Map
from ..utils.device import default_device
from .base_handler import BaseHandler


class LocalHandler(BaseHandler):
    def __init__(self, slam_map: Map, optimizer, camera, config, device=None, **kwargs):
        super().__init__(run_timeout=config.local_mapping.run_timeout, **kwargs)
        self.device = default_device(device)
        if optimizer is None:
            from ..backend.optimizer import LMOptimizer

            optimizer = LMOptimizer(config, camera, logger=self.logger, device=self.device)
        self.map = slam_map
        self.optimizer = optimizer
        self.camera = camera
        self.config = config
        self.window = max(config.optimization.window_size, config.local_mapping.max_neighbors)
        self.last_result: dict = {}
        self._trigger_count = 0

    def step(self) -> None:
        """Full-map BA while the map fits ``max(global_ba_max_keyframes, 2 x
        window)`` keyframes, windowed BA with fixed anchors beyond."""
        self._trigger_count += 1
        every = max(self.config.optimization.ba_every_n_keyframes, 1)
        if self._trigger_count % every != 0:
            return
        all_kfs = self.map.get_keyframes()
        if len(all_kfs) <= 2:
            return
        log_err = self.config.optimization.log_reprojection_error
        err_before = self.map.compute_mean_reprojection_error(self.camera.K) if log_err else -1.0
        # The map lock is held across pack, solve and writeback: a keyframe
        # inserted or a pose updated mid-solve would otherwise be overwritten
        # by results from a stale snapshot.
        with self.map._lock:
            if len(all_kfs) <= max(self.config.optimization.global_ba_max_keyframes, 2 * self.window):
                result = self.map.optimize_global(self.optimizer)
            else:
                result = self.map.optimize_local(self.optimizer, all_kfs[-self.window:])
        err_after = self.map.compute_mean_reprojection_error(self.camera.K) if log_err else -1.0
        result["reproj_before_px"] = err_before
        result["reproj_after_px"] = err_after
        self.last_result = result
        self.logger.debug("local BA over %d KFs: reproj %.3fpx -> %.3fpx", len(all_kfs), err_before, err_after)
