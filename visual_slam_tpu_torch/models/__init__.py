"""End-to-end SLAM systems (port of ``visual_slam_tpu.models``): the mono
``CompiledSLAM``."""

from .compiled_slam import CompiledSLAM  # noqa: F401
