"""Descriptor matching and its filter chain (port of ``visual_slam_tpu.ops.matching``).

The distance + top-2 + cross-check stage runs in kernel K2
(``match_kernels.hamming_top2``), or K4 for a batch of candidate blocks
(``hamming_top2_batched``), on the card and in their plain versions on the
CPU; the JAX package's backend sniffing is gone. All matchers return a
fixed-shape table aligned to the query side. The filters take leading batch
dimensions (one row per candidate block).
"""
from __future__ import annotations

import math

import torch

from .match_kernels import BIG, hamming_distance_matrix, hamming_top2, hamming_top2_batched  # noqa: F401
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
        ok = ok & (colarg.long().gather(-1, ti.long()) == torch.arange(best.shape[-1], device=best.device))
    if max_distance > 0:
        ok = ok & (best <= max_distance)
    return ok


def unique_train(ti: torch.Tensor, dist: torch.Tensor, ok: torch.Tensor, n_train: int) -> torch.Tensor:
    """Keep only the lowest-distance match per train index, ties to the
    lower query index, along the last axis. Returns the updated ``ok``."""
    batch = ti.shape[:-1]
    d = torch.where(ok, dist, BIG)
    best_per_train = torch.full(batch + (n_train,), BIG, dtype=d.dtype, device=d.device)
    best_per_train = best_per_train.scatter_reduce(-1, ti, d, "amin")
    winner = d <= best_per_train.gather(-1, ti) + 1e-6
    qi = torch.arange(ti.shape[-1], device=ti.device).expand(ti.shape)
    q_val = torch.where(winner & ok, qi, 1 << 30)
    best_qi = torch.full(batch + (n_train,), 1 << 30, dtype=qi.dtype, device=qi.device)
    best_qi = best_qi.scatter_reduce(-1, ti, q_val, "amin")
    return ok & winner & (best_qi.gather(-1, ti) == qi)


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
    dominant bins (ties to the lower bin, as the stable argsort gives).
    ``angle2``, ``ti`` and ``ok`` may carry leading batch dimensions."""
    two_pi = 2.0 * math.pi
    da = torch.fmod(angle1 - angle2.gather(-1, ti), two_pi)
    da = torch.where((da != 0) & (da < 0), da + two_pi, da)
    bins = torch.clamp((da / two_pi * n_bins).to(torch.int32), 0, n_bins - 1).long()
    batch = ok.shape[:-1]
    hist = torch.zeros(batch + (n_bins,), dtype=torch.int64, device=ok.device)
    hist = hist.scatter_add(-1, bins, ok.to(torch.int64))
    order = torch.sort(-hist, dim=-1, stable=True).indices
    keep = torch.zeros(batch + (n_bins,), dtype=torch.bool, device=ok.device).scatter(-1, order[..., :keep_bins], True)
    return ok & keep.gather(-1, bins)


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


def match_descriptors_batched(
    desc_q: torch.Tensor,
    desc_c: torch.Tensor,
    valid_q: torch.Tensor,
    valid_c: torch.Tensor,
    angle_q: torch.Tensor,
    angle_c: torch.Tensor,
    ratio: float = 0.75,
    cross_check: bool = True,
    use_orientation: bool = True,
) -> dict:
    """One (K1, 8) query block against C stacked candidate blocks (C, K2, 8)
    in one K4 launch (loop place recognition), then per candidate the ratio
    test, the cross-check, ``unique_train`` and ``orientation_filter``
    (``keep_bins=3``): ``match_descriptors`` of each candidate, stacked.
    Returns ``train_idx`` (C, K1) int64, ``distance`` and ``valid`` (C, K1)
    and ``n_matches`` (C,)."""
    best, second, ti, colarg = hamming_top2_batched(desc_q, desc_c, valid_q, valid_c)
    ok = _nn_ok(best, second, ti, colarg, ratio, cross_check, 0.0)
    ti = ti.long()
    ok = unique_train(ti, best, ok, desc_c.shape[1])
    if use_orientation:
        ok = orientation_filter(angle_q, angle_c, ti, ok, keep_bins=3)
    return {"train_idx": ti, "distance": best, "valid": ok, "n_matches": ok.sum(-1)}
