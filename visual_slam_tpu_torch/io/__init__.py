"""Host-side IO: frame sources, dataset layouts and calibration loaders
(port of ``visual_slam_tpu.io``; ``io/native.py`` is not ported yet)."""

from .source import (  # noqa: F401
    CameraSource,
    DataSourceBase,
    DatasetSource,
    VideoSource,
    imread_color,
    imread_gray,
    to_gray,
)
from .calibration import (  # noqa: F401
    MonoCalibration,
    StereoCalibration,
    UniversalCalibration,
)
