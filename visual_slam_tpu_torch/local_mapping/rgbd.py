"""RGB-D keyframe handler (port of ``visual_slam_tpu.local_mapping.rgbd``):
metric landmarks from the keyframe's depth readings, then the mono
temporal association.

The depths are the ones tracking measured on the frame (``kp_z``); a
keyframe without them looks its keypoints up in its depth map here
(``ops.stereo.measure_keypoint_depths`` on the handler's device).
"""
from __future__ import annotations

import torch

from ..map import KeyFrame
from ..ops.stereo import depth_settings, measure_keypoint_depths
from ..utils.tree import to_host
from .mono import MonoKeyframeHandler
from .stereo import create_depth_points


class RGBDKeyframeHandler(MonoKeyframeHandler):
    def process_keyframe(self, kf: KeyFrame) -> dict:
        created = self._create_depth_points(kf)
        stats = super().process_keyframe(kf)
        stats["rgbd_created"] = created
        return stats

    def _create_depth_points(self, kf: KeyFrame) -> int:
        feats = kf.get_features(0)
        if feats is None:
            return 0
        z, ok = kf.kp_z, kf.kp_z_valid
        if z is None or ok is None:
            if kf.depth is None:
                return 0
            depth = torch.as_tensor(kf.depth, dtype=torch.float32).to(feats.xy.device)
            z, ok = to_host(measure_keypoint_depths(feats, depth, **depth_settings(self.config)))
        return create_depth_points(self, kf, z, ok)
