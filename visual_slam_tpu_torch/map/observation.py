"""Two-way 2D<->3D observation links (port of
``visual_slam_tpu.map.observation``): ``{keyframe_id: {cam_id: keypoint_index}}``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple


class Observations:
    __slots__ = ("_obs",)

    def __init__(self):
        self._obs: Dict[int, Dict[int, int]] = {}

    def add(self, kf_id: int, cam_id: int, kp_idx: int) -> None:
        self._obs.setdefault(kf_id, {})[cam_id] = kp_idx

    def update(self, kf_id: int, cam_id: int, kp_idx: int) -> None:
        self.add(kf_id, cam_id, kp_idx)

    def remove(self, kf_id: int, cam_id: int | None = None) -> None:
        if kf_id not in self._obs:
            return
        if cam_id is None:
            del self._obs[kf_id]
        else:
            self._obs[kf_id].pop(cam_id, None)
            if not self._obs[kf_id]:
                del self._obs[kf_id]

    def get(self, kf_id: int, cam_id: int = 0) -> int | None:
        return self._obs.get(kf_id, {}).get(cam_id)

    def get_keyframe_ids(self) -> list[int]:
        return list(self._obs.keys())

    def items(self) -> Iterator[Tuple[int, int, int]]:
        """Yield (kf_id, cam_id, kp_idx) triples."""
        for kf_id, cams in self._obs.items():
            for cam_id, kp_idx in cams.items():
                yield kf_id, cam_id, kp_idx

    def __len__(self) -> int:
        return sum(len(c) for c in self._obs.values())

    def __contains__(self, kf_id: int) -> bool:
        return kf_id in self._obs
