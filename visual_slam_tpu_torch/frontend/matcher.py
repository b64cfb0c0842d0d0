"""Matcher classes (port of ``visual_slam_tpu.frontend.matcher``).

Every matcher goes through ``ops.matching.match_descriptors``, whose
metric follows the descriptor width: a binary block takes kernel K2, a
float block (128 words) the dense L2 matrix. ``BFMatcherHamming`` is the
binary brute-force matcher, ``BFMatcherL2`` the float one (a binary block
given to it is matched by Hamming: L2 on packed words means nothing), and
``FlannMatcher`` the L2 matcher with an inverted-file escape hatch
(``ops.ann``) at or above ``ann_threshold`` binary train rows.
"""
from __future__ import annotations

import abc

import numpy as np

from ..ops import matching as m_ops
from ..ops.ann import build_ivf_index, ivf_search
from ..ops.detector import Features


class MatchResult(dict):
    """dict with train_idx/distance/valid/n_matches (query-aligned shapes)."""


class BaseMatcher(abc.ABC):
    @abc.abstractmethod
    def match(self, f1: Features, f2: Features) -> MatchResult: ...


class BFMatcherHamming(BaseMatcher):
    """Binary brute-force matcher: cross-check and/or Lowe ratio."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True, use_orientation: bool = False,
                 max_distance: float = 0.0, **_: object):
        self.ratio = float(ratio)
        self.cross_check = bool(cross_check)
        self.use_orientation = bool(use_orientation)
        self.max_distance = float(max_distance)

    def match(self, f1: Features, f2: Features) -> MatchResult:
        return MatchResult(m_ops.match_descriptors(
            f1.desc, f2.desc, f1.valid, f2.valid, f1.angle, f2.angle,
            ratio=self.ratio, cross_check=self.cross_check,
            use_orientation=self.use_orientation, max_distance=self.max_distance,
        ))


class BFMatcherL2(BaseMatcher):
    """Float brute-force matcher: cross-check and/or Lowe ratio."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True, **_: object):
        self.ratio = float(ratio)
        self.cross_check = bool(cross_check)

    def match(self, f1: Features, f2: Features) -> MatchResult:
        return MatchResult(m_ops.match_descriptors(
            f1.desc, f2.desc, f1.valid, f2.valid, ratio=self.ratio, cross_check=self.cross_check,
        ))


class FlannMatcher(BFMatcherL2):
    """Exact search below ``ann_threshold`` train rows (or for float
    blocks); at or above it for binary blocks, a Hamming IVF index over the
    train block, built once per block (cached on the block's identity:
    keyframe feature blocks are immutable) and probed ``n_probe`` buckets
    deep."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True, ann_threshold: int = 8192, n_probe: int = 8,
                 n_clusters: int | None = None, **_: object):
        super().__init__(ratio=ratio, cross_check=cross_check)
        self.ann_threshold = int(ann_threshold)
        self.n_probe = int(n_probe)
        self.n_clusters = n_clusters
        self._index_key = None
        self._index = None

    def match(self, f1: Features, f2: Features) -> MatchResult:
        n = int(f2.desc.shape[0])
        if n < self.ann_threshold or not m_ops.is_binary_desc(f2.desc):
            return super().match(f1, f2)
        key = (id(f2.desc), n)
        if self._index is None or self._index_key != key:
            C = self.n_clusters or max(64, 1 << int(np.log2(max(n, 2) ** 0.5)))
            self._index = build_ivf_index(f2.desc, f2.valid, n_clusters=C)
            self._index_key = key
        return MatchResult(ivf_search(self._index, f1.desc, f1.valid, n_probe=self.n_probe, ratio=self.ratio,
                                      n_train=n))
