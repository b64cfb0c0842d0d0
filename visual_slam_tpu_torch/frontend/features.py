"""Feature detector classes over the port's ORB front end
(port of ``visual_slam_tpu.frontend.features``).

``FastOrbFeature2D`` runs FAST + oriented rBRIEF (``ops.detector``, kernel
K1) on its ``device``. The Shi-Tomasi, gradient-histogram and SIFT
families are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from ..ops import orb as orb_ops
from ..ops.detector import Features, detect_and_describe
from ..utils.device import default_device


class BaseFeature2D(abc.ABC):
    desc_words = 8  # int32 words per descriptor row (256-bit binary family)

    @abc.abstractmethod
    def detectAndCompute(self, image) -> Features: ...

    def detect(self, image) -> Features:
        return self.detectAndCompute(image)

    def compute(self, image, features: Features) -> Features:
        return features


class FastOrbFeature2D(BaseFeature2D):
    """FAST + oriented rBRIEF on ``device``; the sampling matrix and moment
    weights live there."""

    def __init__(self, num_features: int = 1000, fast_threshold: float = 20.0, n_levels: int = 4,
                 scale_factor: float = 1.2, grid: int = 8, device=None, **_: object):
        self.num_features = int(num_features)
        self.fast_threshold = float(fast_threshold)
        self.n_levels = int(n_levels)
        self.scale_factor = float(scale_factor)
        self.grid = int(grid)
        self.device = default_device(device)
        self.sampling = torch.tensor(orb_ops.sampling_matrix_np()).to(self.device)
        self.moment_w = torch.from_numpy(orb_ops.MOMENT_W_NP).to(self.device)

    def detectAndCompute(self, image) -> Features:
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
        return detect_and_describe(
            img.to(self.device), self.sampling, self.moment_w,
            num_features=self.num_features, threshold=self.fast_threshold,
            n_levels=self.n_levels, scale=self.scale_factor, grid=self.grid,
        )


class _NotPorted(BaseFeature2D):
    family = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the {self.family} detector family is not ported yet")

    def detectAndCompute(self, image) -> Features:  # pragma: no cover - never constructed
        raise NotImplementedError


class ShiTomasiOrbFeature2D(_NotPorted):
    family = "Shi-Tomasi ORB"


class GradHistFeature2D(_NotPorted):
    family = "gradient-histogram"


class ShiTomasiGradHistFeature2D(_NotPorted):
    family = "Shi-Tomasi gradient-histogram"


class DoGSiftFeature2D(_NotPorted):
    family = "DoG SIFT"


class SIFTFeature2D(_NotPorted):
    family = "OpenCV SIFT"
