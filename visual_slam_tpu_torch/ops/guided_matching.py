"""Projection-guided landmark-to-keypoint matching
(port of ``visual_slam_tpu.ops.guided_matching``).

Every arena landmark is projected into the predicted pose and matched
against the keypoints inside a pixel window. For binary descriptors kernel
K3 (``match_kernels.guided_top2``) does the gated Hamming top-2, the ratio
and absolute tests and the inversion to one landmark per keypoint. With a
leading B on every arena and keypoint input, and a pose and radius per
sequence (the batched VO step), K3 runs once as ``guided_top2_batched``.
Float descriptors (width 128) never reach K3: they take the JAX package's
dense route, the gated L2 matrix and the same tests and inversion in plain
PyTorch (``_guided_dense``).
"""
from __future__ import annotations

import torch

from .batch import take_rows
from .match_kernels import BIG, guided_top2, guided_top2_batched, top2
from .matching import distance_matrix, is_binary_desc
from .projection import project_points

_NONE = 1 << 30  # no landmark for this keypoint


def _guided_dense(lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio: float, max_distance: float):
    """The dense route: distances gated by |uv - xy|^2 <= r^2, per landmark
    best and second with the ratio and absolute tests, then per keypoint the
    landmark of the lowest distance (within 1e-6), ties to the lower
    landmark index; the minima are exact in any order. Returns (lm_idx
    (..., K) int64, valid (..., K) bool)."""
    M, K = lm_desc.shape[-2], kp_desc.shape[-2]
    d2 = torch.sum((lm_uv[..., :, None, :] - kp_xy[..., None, :, :]) ** 2, dim=-1)
    dist = torch.where(d2 <= radius2[..., None, None], distance_matrix(lm_desc, kp_desc, lm_ok, kp_valid), BIG)
    best, second, kp_of_lm = top2(dist)
    ok = (best < BIG * 0.5) & (best <= max_distance) & (best < ratio * second)
    d_masked = torch.where(ok, best, BIG)
    batch = best.shape[:-1]
    best_per_kp = torch.full(batch + (K,), BIG, dtype=d_masked.dtype, device=d_masked.device)
    best_per_kp = best_per_kp.scatter_reduce(-1, kp_of_lm, d_masked, "amin")
    winner = ok & (d_masked <= best_per_kp.gather(-1, kp_of_lm) + 1e-6)
    mi = torch.arange(M, device=best.device).expand(best.shape)
    lm_val = torch.where(winner, mi, _NONE)
    best_lm = torch.full(batch + (K,), _NONE, dtype=torch.int64, device=best.device)
    best_lm = best_lm.scatter_reduce(-1, kp_of_lm, lm_val, "amin")
    valid = best_lm < _NONE
    return torch.where(valid, best_lm, 0), valid


def guided_match(
    lm_pos: torch.Tensor,  # (M, 3) world positions
    lm_desc: torch.Tensor,  # (M, W) int32 words, W = 8 (binary) or 128 (float)
    lm_valid: torch.Tensor,  # (M,) bool
    T_pred: torch.Tensor,  # (4, 4) predicted T_w2c
    K: torch.Tensor,  # (3, 3)
    kp_xy: torch.Tensor,  # (Kp, 2) pixels
    kp_desc: torch.Tensor,  # (Kp, W)
    kp_valid: torch.Tensor,  # (Kp,) bool
    width: float,
    height: float,
    radius_px: torch.Tensor | float = 15.0,
    ratio: float = 0.8,
    max_distance: float | None = None,
) -> dict:
    """Keypoint-aligned association: ``pts3d (Kp, 3)``, ``valid (Kp,)``,
    ``lm_idx (Kp,)`` and ``n_matches``. ``radius_px`` may be a 0-d tensor
    (the step's rotation-adaptive window). ``max_distance`` None is the
    width's gate: 80 bits, or 0.9 in L2 on unit-norm float descriptors.
    Batched: ``lm_*`` (B, M, ...), ``T_pred`` (B, 4, 4), ``kp_*`` (B, Kp,
    ...) and ``radius_px`` (B,); each output carries the leading B."""
    binary = is_binary_desc(lm_desc)
    if max_distance is None:
        max_distance = 80.0 if binary else 0.9
    uv, z = project_points(K, T_pred, lm_pos)
    visible = (
        lm_valid
        & (z > 0.1)
        & (uv[..., 0] >= 0) & (uv[..., 0] < width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < height)
    )
    r = torch.as_tensor(radius_px, dtype=torch.float32, device=lm_pos.device)
    nb = lm_pos.dim() - 2
    if binary:
        lm_idx, valid = (guided_top2_batched if nb else guided_top2)(
            lm_desc, visible, uv.contiguous(), kp_desc, kp_valid, kp_xy.contiguous(), r * r,
            ratio=ratio, max_distance=max_distance,
        )
    else:
        lm_idx, valid = _guided_dense(lm_desc, visible, uv, kp_desc, kp_valid, kp_xy, r * r, ratio, max_distance)
    valid = valid & kp_valid
    lm_idx = lm_idx.long()
    return {"pts3d": take_rows(lm_pos, lm_idx, nb), "valid": valid, "lm_idx": lm_idx, "n_matches": valid.sum(-1)}
