"""SLAM system state machine (port of ``visual_slam_tpu.state``, unchanged: it is pure Python)."""
from __future__ import annotations

import enum


class State(enum.Enum):
    """Pipeline states: the 8-state machine of the system the JAX package
    was modelled on."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    OK = 3
    LOST = 4
    RELOCALIZING = 5
    MAPPING = 6
    LOOP_CLOSING = 7

    @property
    def index(self) -> int:
        return self.value

    @property
    def description(self) -> str:
        return _DESCRIPTIONS[self]

    @classmethod
    def by_index(cls, idx: int) -> "State":
        return cls(idx)


_DESCRIPTIONS = {
    State.NO_IMAGES_YET: "No images received yet",
    State.NOT_INITIALIZED: "Map not initialized",
    State.INITIALIZING: "Two-view initialization in progress",
    State.OK: "Tracking nominal",
    State.LOST: "Tracking lost",
    State.RELOCALIZING: "Relocalization in progress",
    State.MAPPING: "Local mapping in progress",
    State.LOOP_CLOSING: "Loop closing in progress",
}
