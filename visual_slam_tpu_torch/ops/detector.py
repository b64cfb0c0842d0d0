"""Multi-scale ORB detector: pyramid -> FAST -> NMS -> grid top-k ->
moments + patches (kernel K1, one launch for all levels) -> steered BRIEF
(port of ``visual_slam_tpu.ops.detector``).

The output always has exactly ``num_features`` slots with a validity mask.
A (B, H, W) batch of frames (the batched VO step) goes through every stage
at once, with the batched K1 (one launch for all B frames and levels); its
features carry the leading B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import fast as fast_ops
from . import orb as orb_ops
from . import pyramid as pyr_ops
from .patch_kernels import patches_and_moments_batched, patches_and_moments_levels


class Features(NamedTuple):
    """Fixed-capacity per-frame feature block."""

    xy: torch.Tensor  # (K, 2) float32, full-resolution (x, y) pixels
    response: torch.Tensor  # (K,) float32
    angle: torch.Tensor  # (K,) float32 radians
    octave: torch.Tensor  # (K,) int32 pyramid level
    size: torch.Tensor  # (K,) float32 patch diameter at full resolution
    desc: torch.Tensor  # (K, 8) int32 words of the 256-bit descriptor
    valid: torch.Tensor  # (K,) bool


def level_quotas(num_features: int, n_levels: int, scale: float) -> list[int]:
    """Feature budget per pyramid level (geometric decay by 1/scale)."""
    ws = [(1.0 / scale) ** l for l in range(n_levels)]
    total = sum(ws)
    ks = [max(int(round(num_features * w / total)), 1) for w in ws]
    ks[0] += num_features - sum(ks)
    return ks


def detect_level(
    lvl: torch.Tensor, k: int, threshold: float, grid: int, edge_margin: int, score: str = "fast"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST (or, with ``score="shi_tomasi"``, Shi-Tomasi: ``threshold`` is
    then the relative quality level) scores, NMS, interior mask and grid
    top-k on one (..., H_l, W_l) level: (yx (..., k, 2) int32, response
    (..., k), valid (..., k), subpixel offsets (..., k, 2))."""
    Hl, Wl = lvl.shape[-2:]
    if score == "shi_tomasi":
        scores = fast_ops.shi_tomasi_scores(lvl, quality_level=threshold)
    elif score == "fast":
        scores = fast_ops.fast_scores(lvl, threshold)
    else:
        raise ValueError(f"unknown score {score!r}")
    scores = fast_ops.nms(scores)
    scores = torch.where(fast_ops.interior_mask(Hl, Wl, edge_margin, lvl.device), scores, 0.0)
    yx, resp, valid = fast_ops.top_k_grid(scores, k, grid=grid)
    return yx, resp, valid, fast_ops.subpixel_offsets(scores, yx)


def detect_and_describe(
    img: torch.Tensor,
    sampling: torch.Tensor,
    moment_w: torch.Tensor,
    num_features: int = 1000,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    edge_margin: int = 16,
    score: str = "fast",
) -> Features:
    """Full ORB front end on one (H, W) grayscale image in [0, 255], or on a
    (B, H, W) batch of them (features with a leading B). ``score`` picks
    the corner map (``detect_level``); the tail is the same either way.

    ``sampling`` is the (961, 15360) rotated-BRIEF matrix and ``moment_w``
    the (961, 2) moment weights, both on the image's device."""
    *batch, H0, W0 = img.shape
    batch = tuple(batch)
    img = img.to(torch.float32)
    levels = [lvl.contiguous() for lvl in pyr_ops.build_pyramid(img, n_levels, scale)]
    quotas = level_quotas(num_features, n_levels, scale)
    dets = [detect_level(lvl, k_l, threshold, grid, edge_margin, score) for lvl, k_l in zip(levels, quotas)]
    blurred = [pyr_ops.gaussian_blur(lvl, sigma=2.0, radius=3) for lvl in levels]
    # K1 once for every level (and frame); its outputs are level-major, as the features.
    k1 = patches_and_moments_batched if batch else patches_and_moments_levels
    mom, patches = k1(levels, blurred, [d[0] for d in dets], moment_w)
    ang = torch.atan2(mom[..., 1], mom[..., 0])
    outs = []
    k0 = 0
    for l, (lvl, k_l, (yx, resp, valid, sub)) in enumerate(zip(levels, quotas, dets)):
        Hl, Wl = lvl.shape[-2:]
        sx = W0 / Wl
        sy = H0 / Hl
        xy_full = torch.stack(
            [(yx[..., 1].to(torch.float32) + sub[..., 1]) * sx, (yx[..., 0].to(torch.float32) + sub[..., 0]) * sy],
            dim=-1,
        )
        ang_l = ang[..., k0:k0 + k_l]
        outs.append(
            Features(
                xy=xy_full,
                response=resp,
                angle=ang_l,
                octave=torch.full(batch + (k_l,), l, dtype=torch.int32, device=img.device),
                size=torch.full(
                    batch + (k_l,), orb_ops.PATCH * (sx + sy) * 0.5, dtype=torch.float32, device=img.device
                ),
                # Per level, as the JAX package: the product's rounding stays
                # its own. A batch's level is one product over its B * K_l rows.
                desc=orb_ops.descriptors(patches[..., k0:k0 + k_l, :, :], ang_l, sampling),
                valid=valid,
            )
        )
        k0 += k_l
    return Features(*[torch.cat([getattr(o, f) for o in outs], dim=len(batch)) for f in Features._fields])
