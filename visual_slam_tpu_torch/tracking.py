"""Tracking helpers (port of part of ``visual_slam_tpu.tracking``).

Only ``undistort_features``, which the initializer uses, is ported; the
host ``Tracking`` state machine is not.
"""
from __future__ import annotations

import torch

from .ops.projection import undistort_pixels


def undistort_features(feats, camera):
    """Replace keypoint pixel coordinates with their ideal-pinhole positions
    (no-op for distortion-free cameras)."""
    if not camera.has_distortion:
        return feats
    dev = feats.xy.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    return feats._replace(xy=undistort_pixels(t(camera.K), t(camera.Kinv), t(camera.D), feats.xy))
