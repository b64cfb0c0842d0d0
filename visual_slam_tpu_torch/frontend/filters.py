"""The match-filter dispatcher over ``FeatureTrackingResult`` (port of
``visual_slam_tpu.frontend.filters``).

JAX's filter set, defaults and order: max distance, unique train,
orientation consistency, rectified-stereo rows, region masks, then the
fundamental-matrix RANSAC (orientation and RANSAC on by default; the ratio
test and the cross-check are the matcher's). Each filter ANDs a mask into
the fixed-shape result.

The JAX package draws its RANSAC minimal sets from a key held by the
module. Here the caller passes a ``torch.Generator`` (``gen``; one kept
across calls advances the draws as that key does) or the draws themselves
(``sample_idx`` (n_hyp, 8), as ``ops.epipolar.ransac_fundamental`` takes
them); without either, each call draws from a new generator seeded with
``seed``. The module holds no state.
"""
from __future__ import annotations

import torch

from ..ops import epipolar as ep_ops
from ..ops import matching as m_ops
from .tracker import FeatureTrackingResult


def filter_matches(
    result: FeatureTrackingResult,
    use_ransac_fund_matrix: bool = True,
    use_orientation: bool = True,
    use_stereo: bool = False,
    use_mask_regions: bool = False,
    use_max_distance: bool = False,
    use_unique: bool = False,
    ransac_threshold: float = 1.0,
    ransac_hypotheses: int = 128,
    orientation_bins: int = 30,
    orientation_keep_bins: int = 3,
    row_tolerance: float = 2.0,
    min_disparity: float = 0.0,
    max_disparity: float = 1e9,
    mask_regions=None,
    exclude_regions: bool = True,
    max_distance: float = 64.0,
    logger=None,
    gen: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
    seed: int = 21,
    **_: object,
) -> FeatureTrackingResult:
    ok = result.valid
    f1, f2, ti = result.features1, result.features2, result.train_idx.long()
    if use_max_distance:
        ok = ok & (result.distance <= max_distance)
    if use_unique:
        ok = m_ops.unique_train(ti, result.distance, ok, f2.desc.shape[0])
    if use_orientation:
        ok = m_ops.orientation_filter(f1.angle, f2.angle, ti, ok, n_bins=orientation_bins,
                                      keep_bins=orientation_keep_bins)
    if use_stereo:
        ok = m_ops.stereo_epipolar_filter(f1.xy, f2.xy, ti, ok, row_tolerance=row_tolerance,
                                          min_disparity=min_disparity, max_disparity=max_disparity)
    if use_mask_regions and mask_regions is not None:
        ok = m_ops.region_mask_filter(f1.xy, ok, mask_regions, exclude=exclude_regions)
    if use_ransac_fund_matrix:
        if gen is None and sample_idx is None:
            gen = torch.Generator(device=ok.device).manual_seed(seed)
        res = ep_ops.ransac_fundamental(f1.xy, f2.xy[ti], ok, gen, n_hyp=ransac_hypotheses, thresh=ransac_threshold,
                                        sample_idx=sample_idx)
        ok = ok & res["inliers"]
    out = FeatureTrackingResult(f1, f2, result.train_idx, result.distance, ok)
    if logger is not None:
        logger.debug("filter_matches: %d -> %d", result.n_matches, out.n_matches)
    return out
