"""The port's ``LocalMapping`` and ``MonoKeyframeHandler`` against the JAX
package's, from one shared state (tests/facade_parity.py).

``MonoKeyframeHandler.process_keyframe``: frame 6 of test_slam_e2e.py's
world, with identical features and pose in both packages, becomes a new
keyframe against the shared map; the neighbour matches (K2 and the
orientation filter, exact; the fundamental filter, which
tests/test_torch_frontend.py holds within 2 flipped matches, is off here)
reuse landmarks and triangulate new ones. Tolerances: reused and
triangulated counts equal, the new landmarks observed at the same keypoint
slots and their positions within 1e-3 + 2e-3 relative (measured 2.6e-3 at
2.7, relative 8e-4: a lone f32 DLT fit of a low-parallax pair spreads the
rounding along the ray, ROADMAP's parity rules). ``cull_redundant_keyframes`` and ``enforce_landmark_budget`` on a
map with a keyframe per frame: the same keyframe and landmark ids remain.
"""
import numpy as np
import pytest
import torch

import facade_parity as fp
from visual_slam_tpu.map import KeyFrame as JKeyFrame
from visual_slam_tpu_torch.map import KeyFrame

N_TRACK = 6


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    return fp.world()


def test_process_keyframe_matches_jax(world):
    frames, _, K = world
    jcfg, cfg = fp.configs()
    js = fp.jax_slam(frames, K, jcfg, N_TRACK)
    ts = fp.port_from(js, frames, K, cfg)
    jf, tf = fp.shared_frames(js, ts, frames[N_TRACK], N_TRACK * 0.1)
    jkf, tkf = JKeyFrame.from_frame(jf), KeyFrame.from_frame(tf)
    js.feature_tracker.use_ransac_fund = ts.feature_tracker.use_ransac_fund = False
    old = {p.id for p in js.map.get_map_points()}
    assert old == {p.id for p in ts.map.get_map_points()}
    jstats = js.local_mapping.handler.process_keyframe(jkf)
    tstats = ts.local_mapping.handler.process_keyframe(tkf)
    assert tstats == jstats
    assert jstats["triangulated"] >= 10 and jstats["reused"] >= 10

    def new_points(kf, old_ids):
        return sorted((slot, mp.position) for (cam, slot), mp in kf.map_points.items() if mp.id not in old_ids)

    jn, tn = new_points(jkf, old), new_points(tkf, old)
    assert [s for s, _ in tn] == [s for s, _ in jn]
    np.testing.assert_allclose(np.stack([p for _, p in tn]), np.stack([p for _, p in jn]), rtol=2e-3, atol=1e-3)
    j_links = sorted((slot, mp.id) for (cam, slot), mp in jkf.map_points.items() if mp.id in old)
    t_links = sorted((slot, mp.id) for (cam, slot), mp in tkf.map_points.items() if mp.id in old)
    assert t_links == j_links


@pytest.fixture(scope="module")
def dense(world):
    """The JAX facade with a keyframe per frame (12 frames) and the port's
    copy of its state; redundancy culling at a lowered threshold."""
    frames, _, K = world
    jcfg, cfg = fp.configs(tracking__keyframe_interval=1, map__kf_redundancy_threshold=0.3,
                           map__min_keyframes_before_cull=4, map__budget_protect_recent=2)
    js = fp.jax_slam(frames, K, jcfg, 12)
    return js, fp.port_from(js, frames, K, cfg)


def test_cull_redundant_keyframes_same_ids(dense):
    js, ts = dense
    assert js.map.num_keyframes() >= 6
    jn = js.local_mapping.cull_redundant_keyframes()
    tn = ts.local_mapping.cull_redundant_keyframes()
    assert tn == jn
    assert [k.keyframe_id for k in ts.map.get_keyframes()] == [k.keyframe_id for k in js.map.get_keyframes()]


def test_enforce_landmark_budget_same_ids(dense):
    js, ts = dense
    budget = js.map.num_map_points() // 2
    jn = js.local_mapping.enforce_landmark_budget(budget)
    tn = ts.local_mapping.enforce_landmark_budget(budget)
    assert tn == jn > 0
    assert sorted(p.id for p in ts.map.get_map_points()) == sorted(p.id for p in js.map.get_map_points())
