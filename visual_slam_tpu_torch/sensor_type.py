"""Sensor type enum (port of ``visual_slam_tpu.sensor_type``)."""
from __future__ import annotations

import enum


class SensorType(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2

    @property
    def is_mono(self) -> bool:
        return self is SensorType.MONOCULAR

    @property
    def is_stereo(self) -> bool:
        return self is SensorType.STEREO

    @property
    def is_rgbd(self) -> bool:
        return self is SensorType.RGBD
