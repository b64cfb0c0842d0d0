"""Projection-guided landmark-to-keypoint matching
(port of ``visual_slam_tpu.ops.guided_matching``, binary descriptors).

Every arena landmark is projected into the predicted pose and matched
against the keypoints inside a pixel window; kernel K3
(``match_kernels.guided_top2``) does the gated Hamming top-2, the ratio and
absolute tests and the inversion to one landmark per keypoint. With a
leading B on every arena and keypoint input, and a pose and radius per
sequence (the batched VO step), K3 runs once as ``guided_top2_batched``.
"""
from __future__ import annotations

import torch

from .batch import take_rows
from .match_kernels import guided_top2, guided_top2_batched
from .projection import project_points


def guided_match(
    lm_pos: torch.Tensor,  # (M, 3) world positions
    lm_desc: torch.Tensor,  # (M, 8) int32 words
    lm_valid: torch.Tensor,  # (M,) bool
    T_pred: torch.Tensor,  # (4, 4) predicted T_w2c
    K: torch.Tensor,  # (3, 3)
    kp_xy: torch.Tensor,  # (Kp, 2) pixels
    kp_desc: torch.Tensor,  # (Kp, 8)
    kp_valid: torch.Tensor,  # (Kp,) bool
    width: float,
    height: float,
    radius_px: torch.Tensor | float = 15.0,
    ratio: float = 0.8,
    max_distance: float = 80.0,
) -> dict:
    """Keypoint-aligned association: ``pts3d (Kp, 3)``, ``valid (Kp,)``,
    ``lm_idx (Kp,)`` and ``n_matches``. ``radius_px`` may be a 0-d tensor
    (the step's rotation-adaptive window). Batched: ``lm_*`` (B, M, ...),
    ``T_pred`` (B, 4, 4), ``kp_*`` (B, Kp, ...) and ``radius_px`` (B,); each
    output carries the leading B."""
    uv, z = project_points(K, T_pred, lm_pos)
    visible = (
        lm_valid
        & (z > 0.1)
        & (uv[..., 0] >= 0) & (uv[..., 0] < width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < height)
    )
    r = torch.as_tensor(radius_px, dtype=torch.float32, device=lm_pos.device)
    nb = lm_pos.dim() - 2
    lm_idx, valid = (guided_top2_batched if nb else guided_top2)(
        lm_desc, visible, uv.contiguous(), kp_desc, kp_valid, kp_xy.contiguous(), r * r,
        ratio=ratio, max_distance=max_distance,
    )
    valid = valid & kp_valid
    lm_idx = lm_idx.long()
    return {"pts3d": take_rows(lm_pos, lm_idx, nb), "valid": valid, "lm_idx": lm_idx, "n_matches": valid.sum(-1)}
