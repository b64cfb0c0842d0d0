"""Feature detector classes (port of ``visual_slam_tpu.frontend.features``).

Every class runs on its ``device`` (the card unless the caller names one;
without a card ``None`` raises). The binary families (``desc_words`` 8):
``FastOrbFeature2D``, FAST + oriented rBRIEF (``ops.detector``, kernel K1
once a detect), and ``ShiTomasiOrbFeature2D``, the same tail behind the
Shi-Tomasi corner map. The float families (``desc_words`` 128, f32 bitcast
in int32 words, L2-matched): ``GradHistFeature2D`` and
``ShiTomasiGradHistFeature2D`` (``ops.floatdesc``), ``DoGSiftFeature2D``
(``ops.sift``) and ``SIFTFeature2D`` (OpenCV's SIFT on the host, imported
when built). The float families run no kernel. A (B, H, W) batch (a stereo
pair) goes through a binary detector at once, and through a float one
frame by frame; its features carry the leading B either way.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from ..ops import orb as orb_ops
from ..ops.detector import Features, detect_and_describe
from ..ops.floatdesc import detect_and_describe_gradhist
from ..ops.sift import detect_and_describe_sift
from ..utils.device import default_device


class BaseFeature2D(abc.ABC):
    desc_words = 8  # int32 words per descriptor row: 8 binary (256 bits), 128 float

    @abc.abstractmethod
    def detectAndCompute(self, image) -> Features: ...

    def detect(self, image) -> Features:
        return self.detectAndCompute(image)

    def compute(self, image, features: Features) -> Features:
        return features


def _image(image, device) -> torch.Tensor:
    img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
    return img.to(device)


def _per_frame(detect, img: torch.Tensor) -> Features:
    """``detect`` of one (H, W) image, or of each frame of a (B, H, W)
    batch, stacked on a leading B."""
    if img.ndim == 2:
        return detect(img)
    outs = [detect(im) for im in img]
    return Features(*[torch.stack([getattr(o, f) for o in outs]) for f in Features._fields])


class FastOrbFeature2D(BaseFeature2D):
    """FAST + oriented rBRIEF on ``device``; the sampling matrix and moment
    weights live there."""

    score = "fast"

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
        return detect_and_describe(
            _image(image, self.device), self.sampling, self.moment_w,
            num_features=self.num_features, threshold=self.fast_threshold,
            n_levels=self.n_levels, scale=self.scale_factor, grid=self.grid, score=self.score,
        )


def _quality_level(fast_threshold: float) -> float:
    """The Shi-Tomasi families read ``fast_threshold`` as cv2's relative
    quality level; a value above 1 (FAST units of a shared config) is 0.01."""
    return 0.01 if fast_threshold > 1.0 else fast_threshold


class ShiTomasiOrbFeature2D(FastOrbFeature2D):
    """Shi-Tomasi (min-eigenvalue) corners + rBRIEF, the ORB tail (K1)."""

    score = "shi_tomasi"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fast_threshold = _quality_level(self.fast_threshold)


class GradHistFeature2D(BaseFeature2D):
    """FAST (or Shi-Tomasi) keypoints + the 128-d gradient-histogram float
    descriptor (``ops.floatdesc``), L2-matched."""

    score = "fast"
    desc_words = 128

    def __init__(self, num_features: int = 1000, fast_threshold: float = 20.0, n_levels: int = 4,
                 scale_factor: float = 1.2, grid: int = 8, device=None, **_: object):
        self.num_features = int(num_features)
        self.fast_threshold = float(fast_threshold)
        self.n_levels = int(n_levels)
        self.scale_factor = float(scale_factor)
        self.grid = int(grid)
        self.device = default_device(device)
        self.moment_w = torch.from_numpy(orb_ops.MOMENT_W_NP).to(self.device)

    def _detect(self, img: torch.Tensor) -> Features:
        return detect_and_describe_gradhist(
            img, self.moment_w, num_features=self.num_features, threshold=self.fast_threshold,
            n_levels=self.n_levels, scale=self.scale_factor, grid=self.grid, score=self.score,
        )

    def detectAndCompute(self, image) -> Features:
        return _per_frame(self._detect, _image(image, self.device))


class ShiTomasiGradHistFeature2D(GradHistFeature2D):
    """Shi-Tomasi corners + GradHist float descriptors."""

    score = "shi_tomasi"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fast_threshold = _quality_level(self.fast_threshold)


class DoGSiftFeature2D(BaseFeature2D):
    """DoG scale-space extrema + the 128-d GradHist descriptor at each
    keypoint's scale (``ops.sift``), L2-matched."""

    desc_words = 128

    def __init__(self, num_features: int = 1000, n_octaves: int = 4, n_scales: int = 3,
                 contrast_threshold: float = 0.04, edge_threshold: float = 10.0, grid: int = 8, device=None,
                 **_: object):
        self.num_features = int(num_features)
        self.n_octaves = int(n_octaves)
        self.n_scales = int(n_scales)
        self.contrast_threshold = float(contrast_threshold)
        self.edge_threshold = float(edge_threshold)
        self.grid = int(grid)
        self.device = default_device(device)

    def _detect(self, img: torch.Tensor) -> Features:
        return detect_and_describe_sift(
            img, num_features=self.num_features, n_octaves=self.n_octaves, n_scales=self.n_scales,
            contrast_threshold=self.contrast_threshold, edge_threshold=self.edge_threshold, grid=self.grid,
        )

    def detectAndCompute(self, image) -> Features:
        return _per_frame(self._detect, _image(image, self.device))


class SIFTFeature2D(BaseFeature2D):
    """OpenCV's SIFT on the host (cv2 is imported when the class is built),
    its keypoints and descriptors padded to ``num_features`` slots and
    moved to ``device``."""

    desc_words = 128

    def __init__(self, num_features: int = 1000, device=None, **_: object):
        import cv2

        self.num_features = int(num_features)
        self.device = default_device(device)
        self._sift = cv2.SIFT_create(nfeatures=num_features)

    def _detect(self, image) -> Features:
        img8 = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
        kps, desc = self._sift.detectAndCompute(img8, None)
        K = self.num_features
        xy = np.zeros((K, 2), np.float32)
        response = np.zeros((K,), np.float32)
        angle = np.zeros((K,), np.float32)
        size = np.zeros((K,), np.float32)
        valid = np.zeros((K,), bool)
        d = np.zeros((K, 128), np.float32)
        for i, kp in enumerate(kps[:K]):
            xy[i] = kp.pt
            response[i] = kp.response
            angle[i] = np.deg2rad(kp.angle) if kp.angle >= 0 else 0.0
            size[i] = kp.size
            valid[i] = True
            if desc is not None:
                d[i] = desc[i]
        arrays = (xy, response, angle, np.zeros((K,), np.int32), size, d.view(np.int32), valid)
        return Features(*(torch.from_numpy(a).to(self.device) for a in arrays))

    def detectAndCompute(self, image) -> Features:
        return _per_frame(self._detect, image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image))


