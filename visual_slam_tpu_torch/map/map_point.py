"""3D landmark (port of ``visual_slam_tpu.map.map_point``).

Id counter, position/color/descriptor, observation links, validity
(finite and not bad).
"""
from __future__ import annotations

import itertools

import numpy as np

from .observation import Observations


class MapPoint:
    _ids = itertools.count(0)

    __slots__ = ("id", "position", "color", "descriptor", "observations", "is_bad", "slot")

    def __init__(
        self,
        position: np.ndarray,
        color: np.ndarray | None = None,
        descriptor: np.ndarray | None = None,
    ):
        self.id = next(MapPoint._ids)
        self.position = np.asarray(position, np.float64).reshape(3)
        self.color = np.asarray(color) if color is not None else np.array([128, 128, 128], np.uint8)
        self.descriptor = descriptor
        self.observations = Observations()
        self.is_bad = False
        self.slot = -1  # index in the device-side landmark arena (if resident)

    def update_position(self, position: np.ndarray) -> None:
        self.position = np.asarray(position, np.float64).reshape(3)

    def add_observation(self, kf_id: int, cam_id: int, kp_idx: int) -> None:
        self.observations.add(kf_id, cam_id, kp_idx)

    def remove_observation(self, kf_id: int, cam_id: int | None = None) -> None:
        self.observations.remove(kf_id, cam_id)

    def get_observations(self) -> Observations:
        return self.observations

    def num_observations(self) -> int:
        return len(self.observations)

    @property
    def is_valid(self) -> bool:
        return (not self.is_bad) and bool(np.isfinite(self.position).all())

    def set_bad(self) -> None:
        self.is_bad = True

    def __repr__(self) -> str:
        return f"MapPoint(id={self.id}, pos={self.position.round(3).tolist()}, obs={len(self.observations)})"
