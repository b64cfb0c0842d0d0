"""The port's two-view bootstrap held to the JAX package's distribution
(ROADMAP queue 3, Q3.1).

Both packages bootstrap (``Initializer.initialize`` until it succeeds, with
the two-view BA, as ``SLAM`` wires it) each of 16 seeds of
tests/test_compiled_slam.py's world (``render_sequence(default_rng(seed),
17 frames, step 0.3)``, ``small_config``). Their RANSAC draws differ
(``jax.random`` keys against a ``torch.Generator``), and on these flat
sprites a flipped descriptor tie bit changes the match set, so a seed's
count differs between the packages; a bias would show as a shifted mean of
the per-seed differences.

Band: the mean of the 16 per-seed differences (port - JAX landmarks) lies
within two standard errors of it (2 sd / sqrt(16)), and every seed
bootstraps within 3 frames in both. Measured (this file's seeds): JAX mean
70.4, port 74.5, differences +4.1 +- 22.7 (sd), band 11.3 landmarks, 16 %
of JAX's mean. The port's counts scaled by 0.8 (a 20 % deficit) give -10.8
against a band of 10.3 and fail; the 59-against-84 gap that opened Q3.1 is
29 %.
"""
import logging

import numpy as np
import pytest
import torch

from render import render_sequence
from test_slam_e2e import small_config as jax_small_config
from visual_slam_tpu.backend.optimizer import LMOptimizer as JLMOptimizer
from visual_slam_tpu.camera import PinholeCamera as JCamera
from visual_slam_tpu.frontend.tracker import FeatureTracker as JFeatureTracker
from visual_slam_tpu.initializer import Initializer as JInitializer
from visual_slam_tpu.map import Map as JMap
from visual_slam_tpu_torch.backend.optimizer import LMOptimizer
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.frontend.tracker import FeatureTracker
from visual_slam_tpu_torch.initializer import Initializer
from visual_slam_tpu_torch.map import Map

SEEDS = range(16)
MAX_FRAMES = 4


def _bootstrap(port: bool, frames, K):
    """(frame index of success or None, landmark count)."""
    cam_cls, cfg = (PinholeCamera, Config.from_dict(jax_small_config().to_dict())) if port else (
        JCamera, jax_small_config())
    cam = cam_cls(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    log = logging.getLogger("test_torch_bootstrap")
    if port:
        m, kw = Map(max_frames=cfg.map.max_frames), {"device": "cpu"}
        init = Initializer(cam, cfg, FeatureTracker(cfg.feature, **kw), m, logger=log)
        init.optimizer = LMOptimizer(cfg, cam, logger=log, **kw)
    else:
        m = JMap(max_frames=cfg.map.max_frames)
        init = JInitializer(cam, cfg, JFeatureTracker(cfg.feature), m, logger=log)
        init.optimizer = JLMOptimizer(cfg, cam, logger=log)
    init.add_frame([frames[0]], 0.0)
    for i in range(1, MAX_FRAMES):
        if init.initialize([frames[i]], i * 0.1):
            return i, m.num_map_points()
    return None, m.num_map_points()


@pytest.fixture(scope="module")
def counts():
    out = {"jax": [], "port": []}
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for seed in SEEDS:
            frames, _, K, _ = render_sequence(np.random.default_rng(seed), n_frames=MAX_FRAMES, step=0.3)
            out["jax"].append(_bootstrap(False, frames, K))
            out["port"].append(_bootstrap(True, frames, K))
    finally:
        torch.set_num_threads(before)
    return out


def test_every_seed_bootstraps(counts):
    assert all(at is not None for at, _ in counts["jax"]), counts
    assert all(at is not None for at, _ in counts["port"]), counts


def test_landmark_count_within_jax_spread(counts):
    j = np.array([n for _, n in counts["jax"]], float)
    t = np.array([n for _, n in counts["port"]], float)
    d = t - j
    band = 2.0 * d.std(ddof=1) / np.sqrt(len(d))
    assert abs(d.mean()) <= band, (d.mean(), band, t.tolist(), j.tolist())
