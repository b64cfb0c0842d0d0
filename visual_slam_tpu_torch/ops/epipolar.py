"""Minimal-set sampling for fixed-budget RANSAC
(port of ``visual_slam_tpu.ops.epipolar._sample_minimal_sets``)."""
from __future__ import annotations

import torch


def _sample_minimal_sets(
    gen: torch.Generator, mask: torch.Tensor, n_hyp: int, set_size: int
) -> torch.Tensor:
    """(n_hyp, set_size) int64 indices drawn uniformly, with replacement,
    from the entries where ``mask`` is True, by inverting the mask's
    cumulative count: no host round-trip. Torch cannot reproduce JAX's
    random bits, so only the distribution matches the JAX version (which
    draws from all entries when the mask is empty; here that case returns
    the last index, a degenerate hypothesis either way)."""
    cdf = torch.cumsum(mask.to(torch.float32), dim=0)
    u = torch.rand((n_hyp, set_size), generator=gen, device=mask.device)
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return torch.clamp(idx, max=mask.shape[0] - 1) if mask.shape[0] else idx
