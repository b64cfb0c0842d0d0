"""Feature front end: detectors, matchers, manager and the two-view tracker
(port of ``visual_slam_tpu.frontend``)."""

from .features import BaseFeature2D, FastOrbFeature2D, SIFTFeature2D  # noqa: F401
from .matcher import BaseMatcher, BFMatcherHamming, BFMatcherL2, FlannMatcher  # noqa: F401
from .feature_manager import FeatureManager, feature_factory, matcher_factory  # noqa: F401
from .tracker import FeatureTracker, FeatureTrackingResult  # noqa: F401
