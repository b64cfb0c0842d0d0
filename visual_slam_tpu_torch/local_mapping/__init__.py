"""Local mapping: the keyframe consumer and its monocular handler (port of
``visual_slam_tpu.local_mapping``; the stereo and RGB-D handlers belong to
ROADMAP M9)."""

from .base import BaseKeyframeHandler  # noqa: F401
from .mono import MonoKeyframeHandler  # noqa: F401
from .local_mapping import LocalMapping, make_handler  # noqa: F401
