"""Per-keypoint stereo and RGB-D depth measurement (port of
``visual_slam_tpu.ops.stereo``), plain PyTorch with fixed shapes.

``stereo_feature_depths`` gives every left keypoint a depth from one
(K_l, K_r) distance matrix (Hamming, or L2 for a float family's block)
with the rectified row/disparity gate applied inside it, before the
top-2, ratio test and cross-check, so the nearest neighbour is the best
epipolar-consistent candidate. The JAX package computes it with XLA (its
``distance_matrix`` and ``min2``), not a Pallas kernel: here it is
``matching.distance_matrix`` and ``match_kernels.top2``. Hamming
distances are exact integers, so ``right_idx`` and ``valid`` agree with
the JAX package exactly, ties to the lower index. With a leading batch axis
(the batched stereo step's B pairs) every pair is matched on its own, as
it would be alone. ``sample_depth_at`` is the
RGB-D nearest-pixel lookup. ``measure_keypoint_depths`` is the one rule
for which keypoints have a depth, shared by tracking, the fused frame step
and the keyframe handlers. ``backproject_depths`` and its host twin
``backproject_np`` lift pixels with depths into world points.
"""
from __future__ import annotations

import numpy as np
import torch

from .batch import take_rows
from .match_kernels import BIG, top2
from .matching import distance_matrix

_EPS = 1e-9


def stereo_feature_depths(
    xy_l: torch.Tensor,
    desc_l: torch.Tensor,
    valid_l: torch.Tensor,
    xy_r: torch.Tensor,
    desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    bf: float,
    row_tolerance: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e4,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> dict:
    """Rectified-stereo depth per left keypoint slot. ``xy_*`` (K, 2) pixels,
    ``desc_*`` (K, 8) int32 words (or (K, 128) bitcast floats: L2), ``bf`` the baseline times the focal
    length (pixels x metres). Returns dict(z (K_l,) metres, disparity
    (K_l,), right_idx (K_l,) int64, valid (K_l,) bool). With a leading B on
    every input, B pairs at once and every output with the leading B."""
    nb = xy_l.dim() - 2
    d = distance_matrix(desc_l, desc_r, valid_l, valid_r)
    dv = torch.abs(xy_l[..., :, 1:2] - xy_r[..., None, :, 1])  # (K_l, K_r) row gap
    disp = xy_l[..., :, 0:1] - xy_r[..., None, :, 0]
    gate = (dv <= row_tolerance) & (disp > min_disparity) & (disp < max_disparity)
    d = torch.where(gate, d, BIG)
    best, second, ri = top2(d)
    ok = best < BIG * 0.5
    if ratio > 0:
        ok = ok & (best < ratio * second)
    if cross_check:
        rev = torch.argmin(d, dim=-2)
        ok = ok & (take_rows(rev, ri, nb) == torch.arange(d.shape[-2], device=d.device))
    dsp = torch.clamp(xy_l[..., 0] - take_rows(xy_r[..., 0], ri, nb), min=_EPS)
    return {"z": bf / dsp, "disparity": dsp, "right_idx": ri, "valid": ok}


def sample_depth_at(depth: torch.Tensor, xy: torch.Tensor, depth_scale: float = 1.0) -> dict:
    """Nearest-pixel depth per keypoint (the RGB-D path): nearest, not
    bilinear, since depth maps step at object boundaries. Returns dict(z
    (K,), valid (K,)): valid where in bounds and z finite and > 0."""
    H, W = depth.shape[:2]
    ui = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    inb = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    z = depth[vi, ui].to(torch.float32) * depth_scale
    return {"z": z, "valid": inb & (z > 0) & torch.isfinite(z)}


def depth_settings(config) -> dict:
    """The ``measure_keypoint_depths`` settings a ``Config`` gives: the row
    tolerance and depth scale of tracking, the depth window of local
    mapping."""
    return {
        "row_tolerance": config.tracking.stereo_row_tolerance,
        "depth_scale": config.tracking.depth_scale,
        "min_depth": config.local_mapping.min_depth,
        "max_depth": config.local_mapping.max_depth,
    }


def measure_keypoint_depths(
    feats,
    second,
    bf: float = 0.0,
    row_tolerance: float = 2.0,
    depth_scale: float = 1.0,
    min_depth: float = 0.1,
    max_depth: float = 50.0,
) -> tuple:
    """Depth per camera-0 keypoint slot of ``feats`` from the frame's second
    modality: ``second`` is the right camera's features of a rectified pair
    (``bf`` the baseline times the focal length; disparities above
    ``bf / min_depth`` are not searched), or the (H, W) depth map of an
    RGB-D frame (times ``depth_scale`` gives metres). Returns (z (K,),
    valid (K,)) on the features' device: valid where measured on a valid
    keypoint and inside (``min_depth``, ``max_depth``)."""
    if isinstance(second, torch.Tensor):
        res = sample_depth_at(second, feats.xy, depth_scale)
        # Empty slots sit at (0, 0), where the depth map is often set:
        # without feats.valid they would mint landmarks on that ray.
        ok = res["valid"] & feats.valid
    else:
        res = stereo_feature_depths(feats.xy, feats.desc, feats.valid, second.xy, second.desc, second.valid, bf,
                                    row_tolerance=row_tolerance, max_disparity=bf / max(min_depth, 1e-6))
        ok = res["valid"]
    z = res["z"]
    return z, ok & (z > min_depth) & (z < max_depth)


def backproject_depths(Kinv: torch.Tensor, T_c2w: torch.Tensor, xy: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixels (K, 2) with depths (K,) -> world points (K, 3)."""
    rays = torch.stack([xy[:, 0], xy[:, 1], torch.ones_like(z)], dim=-1) @ Kinv.T
    return (rays * z[:, None]) @ T_c2w[:3, :3].T + T_c2w[:3, 3]


def backproject_np(Kinv, R_c2w, t_c2w, xy, z) -> np.ndarray:
    """Host twin of ``backproject_depths`` (float64 numpy): pixels (K, 2) +
    depths (K,) -> world points (K, 3), for the keyframe handlers and the
    one-frame bootstraps."""
    xy = np.asarray(xy)
    rays = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ np.asarray(Kinv).T
    return (rays * np.asarray(z)[:, None]) @ np.asarray(R_c2w).T + np.asarray(t_c2w)
