"""Pluggable tracking strategies (port of ``visual_slam_tpu.trackingalgorithm``):
``MonoTracking`` is the default monocular strategy of ``Tracking``,
``FusedMonoTracking`` the one-step variant (``tracking.fused_pipeline``)."""

from .base import BaseTrackingAlgorithm  # noqa: F401
from .mono_tracking import MonoTracking  # noqa: F401
from .fused_mono import FusedMonoTracking  # noqa: F401
