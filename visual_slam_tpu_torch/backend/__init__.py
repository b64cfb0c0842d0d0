"""Bundle adjustment (port of ``visual_slam_tpu.backend``): the dense
LM/Schur solver and the optimizer facade over the map."""

from .ba import BAProblem, bundle_adjust, bundle_adjust_robust  # noqa: F401
from .optimizer import BaseOptimizer, LMOptimizer  # noqa: F401
