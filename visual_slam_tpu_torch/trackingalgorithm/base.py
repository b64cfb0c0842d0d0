"""Tracking-strategy ABC (port of ``visual_slam_tpu.trackingalgorithm.base``)."""
from __future__ import annotations

import abc


class BaseTrackingAlgorithm(abc.ABC):
    """Per-frame pose-tracking strategy. Receives the ``Tracking``
    orchestrator (camera, config, map) and the new ``Frame``; returns the
    info dict (with 'ok', 'n_inliers', 'inlier_ratio')."""

    @abc.abstractmethod
    def track_frame(self, tracking, frame) -> dict: ...

    def process(self, tracking, images, timestamp, depth):
        """Frame creation, pose prediction, ``track_frame``. Strategies that
        fuse detection into their device step override it. Returns (frame,
        info)."""
        frame = tracking._create_frame(images, timestamp, depth)
        tracking._predict_pose(frame)
        return frame, self.track_frame(tracking, frame)
