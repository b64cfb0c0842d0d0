"""FeatureTracker: detect + match + filter chain
(port of ``visual_slam_tpu.frontend.tracker``).

``FeatureTrackingResult`` is a fixed-shape match table with host views on
demand. The filter chain: orientation consistency, then the RANSAC
fundamental-matrix filter (``ops.epipolar.ransac_fundamental``), whose
minimal sets come from one ``torch.Generator`` on the device, seeded from
``filter_params["seed"]`` (the JAX package's ``PRNGKey``) and advanced by
every call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FeatureConfig
from ..ops import epipolar as ep_ops
from ..ops.detector import Features
from ..ops.matching import orientation_filter
from ..utils.device import default_device
from ..utils.tree import as_numpy as _np
from .feature_manager import FeatureManager


@dataclass
class FeatureTrackingResult:
    """Match table between a query (1 = cur) and a train (2 = ref) frame;
    ``valid`` is the live mask."""

    features1: Features
    features2: Features
    train_idx: torch.Tensor  # (K,) for query slot i, the matched train slot
    distance: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,) bool

    @property
    def n_matches(self) -> int:
        return int(self.valid.sum())

    @property
    def idxs1(self) -> np.ndarray:
        return np.nonzero(_np(self.valid))[0]

    @property
    def idxs2(self) -> np.ndarray:
        return _np(self.train_idx)[self.idxs1]

    @property
    def kps1_matched(self) -> np.ndarray:
        return _np(self.features1.xy)[self.idxs1]

    @property
    def kps2_matched(self) -> np.ndarray:
        return _np(self.features2.xy)[self.idxs2]

    def filter_by_mask(self, mask) -> "FeatureTrackingResult":
        """AND an extra (K,) slot-aligned mask into the result."""
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.valid.device)
        return FeatureTrackingResult(self.features1, self.features2, self.train_idx, self.distance,
                                     self.valid & mask)


class FeatureTracker:
    def __init__(self, config: FeatureConfig, device=None):
        self.config = config
        self.device = default_device(device)
        self.manager = FeatureManager(config, device=self.device)
        fp = dict(config.filter_params)
        self.use_ransac_fund = bool(fp.get("use_ransac_fund_matrix", True))
        self.ransac_thresh_px = float(fp.get("ransac_threshold", 1.0))
        self.ransac_hypotheses = int(fp.get("ransac_hypotheses", 128))
        self.use_orientation = bool(fp.get("use_orientation", True))
        self.orientation_bins = int(fp.get("orientation_bins", 30))
        self.orientation_keep = int(fp.get("orientation_keep_bins", 3))
        self._gen = torch.Generator(device=self.device).manual_seed(int(fp.get("seed", 0)))

    @property
    def desc_words(self) -> int:
        return int(getattr(self.manager.detector, "desc_words", 8))

    def detectAndCompute(self, image) -> Features:
        return self.manager.detectAndCompute(image)

    def match(self, f1: Features, f2: Features, sample_idx: torch.Tensor | None = None) -> FeatureTrackingResult:
        """Match and filter; ``sample_idx`` (n_hyp, 8) replaces the RANSAC
        draws (the tests feed the JAX sampler's)."""
        res = self.manager.match(f1, f2)
        out = FeatureTrackingResult(f1, f2, res["train_idx"], res["distance"], res["valid"])
        if self.use_orientation and not getattr(self.manager.matcher, "use_orientation", False):
            ok = orientation_filter(f1.angle, f2.angle, out.train_idx, out.valid,
                                    n_bins=self.orientation_bins, keep_bins=self.orientation_keep)
            out = FeatureTrackingResult(f1, f2, out.train_idx, out.distance, ok)
        if self.use_ransac_fund:
            out = self._ransac_fundamental_filter(out, sample_idx)
        return out

    def _ransac_fundamental_filter(self, r: FeatureTrackingResult, sample_idx=None) -> FeatureTrackingResult:
        """Geometric consistency on pixel coordinates."""
        res = ep_ops.ransac_fundamental(
            r.features1.xy, r.features2.xy[r.train_idx], r.valid, self._gen,
            n_hyp=self.ransac_hypotheses, thresh=self.ransac_thresh_px, sample_idx=sample_idx,
        )
        return FeatureTrackingResult(r.features1, r.features2, r.train_idx, r.distance, r.valid & res["inliers"])

    def track(self, image_cur, features_ref: Features) -> FeatureTrackingResult:
        """Detect on the current image and match against reference features."""
        return self.match(self.detectAndCompute(image_cur), features_ref)
