"""Bundle adjustment (port of ``visual_slam_tpu.backend``): the dense
LM/Schur solver, the optimizer facade over the map and, in ``adam``, the
Adam solver behind ``optimization.solver="adam"``."""

from .ba import (  # noqa: F401
    BAProblem,
    bundle_adjust,
    bundle_adjust_robust,
    mean_reprojection_error,
    residual_norms,
)
from .optimizer import BaseOptimizer, LMOptimizer  # noqa: F401
