"""Keypoint spatial filters on ``Features`` blocks: mask updates only, fixed
shapes (port of ``visual_slam_tpu.ops.keypoint_filters``).

Grid top-N per cell and radius non-max suppression over the (N, N) pairs,
and their dispatcher, which runs without a logger. Each returns the block
with only ``valid`` changed; ties in the response go to the lower slot.
"""
from __future__ import annotations

import torch

from .detector import Features


def _stronger(resp: torch.Tensor) -> torch.Tensor:
    """(N, N): entry j stronger than entry i, ties to the lower index."""
    idx = torch.arange(resp.shape[0], device=resp.device)
    return (resp[None, :] > resp[:, None]) | ((resp[None, :] == resp[:, None]) & (idx[None, :] < idx[:, None]))


def filter_keypoints_grid(feats: Features, width: int, height: int, grid: int = 8, per_cell: int = 10) -> Features:
    """Keep the ``per_cell`` strongest valid responses of each cell of a
    ``grid`` x ``grid`` partition of the image."""
    # The image size as a tensor on the keypoints' device: CUDA divides by a
    # Python number through its reciprocal, which moves keypoints on a cell's
    # edge (y = 47 of 376, grid 8) into the cell below; JAX divides exactly.
    size = torch.tensor([float(width), float(height)], dtype=feats.xy.dtype, device=feats.xy.device)
    c = torch.clamp((feats.xy / size * grid).to(torch.int32), 0, grid - 1)
    cell = c[:, 1] * grid + c[:, 0]
    resp = torch.where(feats.valid, feats.response, -torch.inf)
    rank = torch.sum((cell[:, None] == cell[None, :]) & _stronger(resp), dim=1)
    return feats._replace(valid=feats.valid & (rank < per_cell))


def filter_keypoints_nms(feats: Features, radius: float = 5.0) -> Features:
    """Radius non-max suppression: drop a keypoint when a stronger valid one
    lies within ``radius`` pixels."""
    resp = torch.where(feats.valid, feats.response, -torch.inf)
    d2 = torch.sum((feats.xy[:, None, :] - feats.xy[None, :, :]) ** 2, dim=-1)
    suppressed = torch.any((d2 <= radius * radius) & _stronger(resp) & feats.valid[None, :], dim=1)
    return feats._replace(valid=feats.valid & ~suppressed)


def filter_keypoints(
    feats: Features,
    width: int,
    height: int,
    use_grid: bool = False,
    use_nms: bool = False,
    grid: int = 8,
    per_cell: int = 10,
    nms_radius: float = 5.0,
    logger=None,
    **_: object,
) -> Features:
    """The grid filter, then NMS, each when asked for; the valid count goes
    to ``logger.debug`` when a logger is given."""
    if use_grid:
        feats = filter_keypoints_grid(feats, width, height, grid=grid, per_cell=per_cell)
    if use_nms:
        feats = filter_keypoints_nms(feats, radius=nms_radius)
    if logger is not None:
        logger.debug("filter_keypoints: %d valid", int(feats.valid.sum()))
    return feats
