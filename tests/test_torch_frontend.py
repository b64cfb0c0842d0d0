"""The torch port's front end (``FeatureManager``, ``BFMatcherHamming``,
``FeatureTracker``) against the JAX package on the CPU, on a rendered frame
pair: both packages get the JAX detector's features, so the matches are
compared exactly and the RANSAC fundamental-matrix filter, fed the JAX
sampler's minimal sets, within 2 flipped matches (Sampson errors on the
1 px threshold)."""
import jax
import numpy as np
import pytest
import torch

from render import render_sequence
from visual_slam_tpu.config import Config as JConfig
from visual_slam_tpu.frontend import feature_manager as jfm
from visual_slam_tpu.frontend.tracker import FeatureTracker as JFeatureTracker
from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.frontend import feature_manager as fm
from visual_slam_tpu_torch.frontend.tracker import FeatureTracker
from visual_slam_tpu_torch.interop import features_from_numpy

torch.set_num_threads(1)


def _cfg(cls, **filter_params):
    cfg = cls()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.feature.filter_params = dict(filter_params)
    return cfg


@pytest.fixture(scope="module")
def pair():
    frames, _, _, _ = render_sequence(np.random.default_rng(42), n_frames=2, step=0.3)
    jt = JFeatureTracker(_cfg(JConfig).feature)
    return jt.detectAndCompute(frames[1]), jt.detectAndCompute(frames[0])


def test_matches_before_ransac_equal_jax(pair):
    f1, f0 = pair
    ref = JFeatureTracker(_cfg(JConfig, use_ransac_fund_matrix=False).feature).match(f1, f0)
    got = FeatureTracker(_cfg(Config, use_ransac_fund_matrix=False).feature, device="cpu").match(
        features_from_numpy(f1), features_from_numpy(f0))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.train_idx.numpy()[v], np.asarray(ref.train_idx)[v])
    assert got.n_matches == ref.n_matches > 60
    np.testing.assert_array_equal(got.idxs2, ref.idxs2)
    np.testing.assert_array_equal(got.kps2_matched, ref.kps2_matched)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_filter_with_injected_draws(pair, seed):
    f1, f0 = pair
    jt = JFeatureTracker(_cfg(JConfig, seed=seed).feature)
    pre = JFeatureTracker(_cfg(JConfig, use_ransac_fund_matrix=False).feature).match(f1, f0)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    idx = jepi._sample_minimal_sets(sub, pre.valid, jt.ransac_hypotheses, 8)
    ref = jt.match(f1, f0)
    got = FeatureTracker(_cfg(Config).feature, device="cpu").match(features_from_numpy(f1), features_from_numpy(f0),
                                                     sample_idx=torch.from_numpy(np.array(idx)))
    assert np.sum(got.valid.numpy() != np.asarray(ref.valid)) <= 2
    assert abs(got.n_matches - ref.n_matches) <= 2


@pytest.mark.parametrize("kind,name",
                         [("detector", n) for n in jfm._DETECTORS] + [("matcher", n) for n in jfm._MATCHERS])
def test_every_factory_name_builds(kind, name):
    """Every name of the JAX package's two factory tables builds in the port
    (``sift_cv2`` where cv2 is installed), as the same class, with the
    JAX detector's descriptor width."""
    if name == "sift_cv2":
        pytest.importorskip("cv2")
    if kind == "matcher":
        assert type(fm.matcher_factory(name)).__name__ == type(jfm.matcher_factory(name)).__name__
        return
    det = fm.feature_factory(name, num_features=64, device="cpu")
    ref = jfm.feature_factory(name, num_features=64)
    assert type(det).__name__ == type(ref).__name__
    assert det.desc_words == ref.desc_words
    assert set(fm._DETECTORS) == set(jfm._DETECTORS) and set(fm._MATCHERS) == set(jfm._MATCHERS)
