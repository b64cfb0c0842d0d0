"""Map representation: Pose, Frame, KeyFrame, MapPoint, Observations, Map
(port of ``visual_slam_tpu.map``: host bookkeeping in numpy)."""

from .pose import Pose  # noqa: F401
from .observation import Observations  # noqa: F401
from .map_point import MapPoint  # noqa: F401
from .frame import Frame, FrameBase  # noqa: F401
from .keyframe import KeyFrame  # noqa: F401
from .map import Map  # noqa: F401
