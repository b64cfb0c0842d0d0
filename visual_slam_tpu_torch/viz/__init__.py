"""Visualization (port of ``visual_slam_tpu.viz``; OpenCV and open3d
optional)."""

from .feature_viz import FeatureVisualizer  # noqa: F401
from .map_viz import MapVisualizer, frustum_lines  # noqa: F401
