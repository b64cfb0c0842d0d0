"""Descriptor matching and its filter chain (port of ``visual_slam_tpu.ops.matching``).

The distance + top-2 + cross-check stage runs in kernel K2
(``match_kernels.hamming_top2``) on the card and in its plain version on
the CPU; the JAX package's backend sniffing is gone. All matchers return a
fixed-shape table aligned to the query side.
"""
from __future__ import annotations

import math

import torch

from .match_kernels import BIG, hamming_distance_matrix, hamming_top2  # noqa: F401 (re-export)
from .match_kernels import top2 as min2  # (best, second, argmin), first-index ties


def match_nn(
    dist: torch.Tensor, ratio: float = 0.75, cross_check: bool = True, max_distance: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-neighbour match with Lowe ratio and optional cross-check on
    a dense distance matrix: (train_idx (K1,), distance (K1,), valid (K1,))."""
    best, second, ti = min2(dist)
    rev = torch.argmin(dist, dim=0)
    return ti, best, _nn_ok(best, second, ti, rev, ratio, cross_check, max_distance)


def _nn_ok(best, second, ti, colarg, ratio, cross_check, max_distance) -> torch.Tensor:
    """Validity of each query's best match: ratio test, cross-check against
    the train column's argmin query, absolute distance."""
    ok = best < BIG * 0.5
    if ratio > 0:
        ok = ok & (best < ratio * second)
    if cross_check:
        ok = ok & (colarg.long()[ti.long()] == torch.arange(best.shape[0], device=best.device))
    if max_distance > 0:
        ok = ok & (best <= max_distance)
    return ok


def unique_train(ti: torch.Tensor, dist: torch.Tensor, ok: torch.Tensor, n_train: int) -> torch.Tensor:
    """Keep only the lowest-distance match per train index, ties to the
    lower query index. Returns the updated ``ok``."""
    d = torch.where(ok, dist, BIG)
    best_per_train = torch.full((n_train,), BIG, dtype=d.dtype, device=d.device)
    best_per_train = best_per_train.scatter_reduce(0, ti, d, "amin")
    winner = d <= best_per_train[ti] + 1e-6
    qi = torch.arange(ti.shape[0], device=ti.device)
    q_val = torch.where(winner & ok, qi, 1 << 30)
    best_qi = torch.full((n_train,), 1 << 30, dtype=qi.dtype, device=qi.device)
    best_qi = best_qi.scatter_reduce(0, ti, q_val, "amin")
    return ok & winner & (best_qi[ti] == qi)


def orientation_filter(
    angle1: torch.Tensor,
    angle2: torch.Tensor,
    ti: torch.Tensor,
    ok: torch.Tensor,
    n_bins: int = 30,
    keep_bins: int = 1,
) -> torch.Tensor:
    """Rotation-consistency filter: histogram the per-match angle
    difference into ``n_bins`` and keep matches in the ``keep_bins``
    dominant bins (ties to the lower bin, as the stable argsort gives)."""
    two_pi = 2.0 * math.pi
    da = torch.fmod(angle1 - angle2[ti], two_pi)
    da = torch.where((da != 0) & (da < 0), da + two_pi, da)
    bins = torch.clamp((da / two_pi * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int64, device=ok.device)
    hist = hist.scatter_add(0, bins, ok.to(torch.int64))
    order = torch.sort(-hist, stable=True).indices
    keep = torch.zeros(n_bins, dtype=torch.bool, device=ok.device).scatter(0, order[:keep_bins], True)
    return ok & keep[bins]


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    angle1: torch.Tensor | None = None,
    angle2: torch.Tensor | None = None,
    ratio: float = 0.75,
    cross_check: bool = True,
    use_orientation: bool = False,
    n_bins: int = 30,
    keep_bins: int = 3,
    max_distance: float = 0.0,
) -> dict:
    """K2 match -> unique-train -> optional orientation filter. Returns
    ``train_idx`` (K1,) int64, ``distance``, ``valid`` and ``n_matches``
    (a 0-d tensor: the step never reads it on the host). On the card the
    (K1, K2) distance matrix never exists: kernel K2 reduces it in place."""
    d, second, ti, colarg = hamming_top2(desc1, desc2, valid1, valid2)
    ok = _nn_ok(d, second, ti, colarg, ratio, cross_check, max_distance)
    ti = ti.long()
    ok = unique_train(ti, d, ok, desc2.shape[0])
    if use_orientation and angle1 is not None:
        ok = orientation_filter(angle1, angle2, ti, ok, n_bins=n_bins, keep_bins=keep_bins)
    return {"train_idx": ti, "distance": d, "valid": ok, "n_matches": ok.sum()}
