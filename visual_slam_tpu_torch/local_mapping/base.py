"""Keyframe handler ABC (port of ``visual_slam_tpu.local_mapping.base``)."""
from __future__ import annotations

import abc
import logging

from ..camera import Camera
from ..config import Config
from ..map import KeyFrame, Map
from ..utils.device import default_device


class BaseKeyframeHandler(abc.ABC):
    def __init__(self, camera: Camera, config: Config, slam_map: Map, feature_tracker,
                 logger: logging.Logger | None = None, device=None):
        self.camera = camera
        self.config = config
        self.map = slam_map
        self.tracker = feature_tracker
        self.logger = logger or logging.getLogger(self.__class__.__name__)
        self.device = default_device(device)

    @abc.abstractmethod
    def process_keyframe(self, kf: KeyFrame) -> dict:
        """Associate the new keyframe with the map: reuse neighbour landmarks
        and triangulate new ones. Returns a stats dict."""
