"""Background work handlers: local and global bundle adjustment
(port of ``visual_slam_tpu.handlers``)."""

from .base_handler import BaseHandler  # noqa: F401
from .local_handler import LocalHandler  # noqa: F401
from .global_handler import GlobalHandler  # noqa: F401
