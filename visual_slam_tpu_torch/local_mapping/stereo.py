"""Stereo keyframe handler (port of ``visual_slam_tpu.local_mapping.stereo``):
metric landmarks from the keyframe's own left/right depths, then the mono
temporal association (neighbour matching and triangulation).

The depths are the ones tracking measured on the frame (``kp_z``); a
keyframe without them is measured here, with one row-gated Hamming pass on
the handler's device (``ops.stereo.measure_keypoint_depths``). Each
keypoint slot with a valid depth in range and no landmark yet backprojects
into a new landmark carrying its descriptor.
"""
from __future__ import annotations

import numpy as np

from ..initializer import _pixel_color
from ..map import KeyFrame, MapPoint
from ..ops.stereo import backproject_np, depth_settings, measure_keypoint_depths
from ..utils.tree import to_host
from .mono import MonoKeyframeHandler


class StereoKeyframeHandler(MonoKeyframeHandler):
    def process_keyframe(self, kf: KeyFrame) -> dict:
        created = self._create_stereo_points(kf)
        stats = super().process_keyframe(kf)
        stats["stereo_created"] = created
        return stats

    def _create_stereo_points(self, kf: KeyFrame) -> int:
        if kf.get_features(0) is None:
            return 0
        bf = float(getattr(self.camera, "bf", 0.0))
        if bf <= 0:
            self.logger.warning("stereo handler: camera has no baseline")
            return 0
        z, ok = kf.kp_z, kf.kp_z_valid
        if z is None or ok is None:
            if kf.get_features(1) is None:
                return 0
            z, ok = to_host(measure_keypoint_depths(kf.get_features(0), kf.get_features(1), bf,
                                                    **depth_settings(self.config)))
        return create_depth_points(self, kf, z, ok)


def create_depth_points(handler, kf: KeyFrame, z: np.ndarray, ok: np.ndarray) -> int:
    """A landmark at each camera-0 keypoint slot of ``kf`` with a valid depth
    (``measure_keypoint_depths``'s ``valid``) and no landmark yet,
    backprojected at that depth, with the slot's descriptor. Returns how
    many were created."""
    xy = kf.keypoints(0)
    desc = kf.descriptors(0)
    p_w = backproject_np(handler.camera.Kinv, kf.R_c2w, kf.t_c2w, xy, z)
    img = kf.get_image(0)
    created = 0
    for i in np.nonzero(ok)[0]:
        if kf.get_map_point(0, int(i)) is None:
            mp = MapPoint(p_w[i], color=_pixel_color(img, xy[i]), descriptor=desc[i])
            kf.add_map_point(0, int(i), mp)
            handler.map.add_map_point(mp)
            created += 1
    return created
