"""Matcher classes (port of ``visual_slam_tpu.frontend.matcher``).

``BFMatcherHamming`` is the binary brute-force matcher over kernel K2
(``ops.matching.match_descriptors``). The L2 and FLANN matchers of the
float families are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import abc

from ..ops import matching as m_ops
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
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the L2 matcher (float descriptor families) is not ported yet")

    def match(self, f1: Features, f2: Features) -> MatchResult:  # pragma: no cover - never constructed
        raise NotImplementedError


class FlannMatcher(BFMatcherL2):
    pass
