"""Local mapping: the keyframe consumer and its monocular, stereo and RGB-D
handlers (port of ``visual_slam_tpu.local_mapping``)."""

from .base import BaseKeyframeHandler  # noqa: F401
from .mono import MonoKeyframeHandler  # noqa: F401
from .rgbd import RGBDKeyframeHandler  # noqa: F401
from .stereo import StereoKeyframeHandler  # noqa: F401
from .local_mapping import LocalMapping, make_handler  # noqa: F401
