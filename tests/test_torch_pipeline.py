"""The torch port's fused mono tracking step with the local map, against
the JAX step and ground truth on the synthetic sprite world
(tests/test_pipeline.py's setup, with a 512-slot arena)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu import pipeline as jp
from visual_slam_tpu.ops.detector import detect_and_describe
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import pipeline as tp

from render import camera_path, make_world, render, render_with_depth

torch.set_num_threads(1)

NF, M = 256, 512
W, H, F = 320, 240, 260.0
STEP_KW = dict(num_features=NF, fast_threshold=12.0, n_levels=2, grid=4, pnp_hypotheses=64,
               local_map=True, width=W, height=H)
R_ATOL, T_ATOL = 0.01, 0.06  # tests/test_pipeline.py's bounds on poses


@pytest.fixture(scope="module")
def setup():
    """Frame-0 keypoints get landmarks from the z-buffer; the same
    landmarks (and descriptors) fill the first slots of the arena."""
    rng = np.random.default_rng(3)
    world = make_world(rng)
    Ts = camera_path(6, step=0.25)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
    frames = [render(world, T, K, W, H) for T in Ts]
    feats0 = detect_and_describe(jnp.asarray(frames[0]), num_features=NF, threshold=12.0, n_levels=2, grid=4)
    xy, valid = np.asarray(feats0.xy), np.asarray(feats0.valid)
    _, zbuf = render_with_depth(world, Ts[0], K, W, H)
    Kinv = np.linalg.inv(K)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        ui, vi = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= ui < W and 0 <= vi < H and zbuf[vi, ui] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * zbuf[vi, ui]
            has[i] = True
    state = jp.init_track_state(feats0, lm, has, np.eye(4), local_map_size=M)
    lm_pos = np.zeros((M, 3), np.float32)
    lm_desc = np.zeros((M, 8), np.uint32)
    lm_valid = np.zeros(M, bool)
    lm_pos[:NF], lm_desc[:NF], lm_valid[:NF] = lm, np.asarray(feats0.desc), has
    state = jp.set_local_map(state, lm_pos, lm_desc, lm_valid)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    return K, frames, Ts, state, np_state


@pytest.fixture(scope="module")
def tstep(setup):
    return tp.make_track_step(setup[0], device="cpu", **STEP_KW)


def test_state_carries_over_bit_for_bit(setup):
    _, _, _, _, np_state = setup
    s = interop.track_state_from_numpy(np_state, "cpu", seed=0)
    np.testing.assert_array_equal(interop.desc_to_uint32(s.ref_feats.desc), np_state.ref_feats.desc)
    np.testing.assert_array_equal(interop.desc_to_uint32(s.lm_desc), np_state.lm_desc)
    np.testing.assert_array_equal(s.ref_feats.xy.numpy(), np_state.ref_feats.xy)
    np.testing.assert_array_equal(s.lm_pos.numpy(), np_state.lm_pos)
    np.testing.assert_array_equal(s.lm_valid.numpy(), np_state.lm_valid)
    np.testing.assert_array_equal(s.T_rel.numpy(), np_state.T_rel)


def test_step_matches_jax_and_ground_truth(setup, tstep):
    """Frames 1-2 from the same carried-over state: both steps within
    (R 0.01, t 0.06) of ground truth and of each other. RANSAC draws
    differ (torch cannot reproduce JAX's random bits), so poses are
    compared, not draws."""
    K, frames, Ts, jstate, np_state = setup
    jstep = jp.make_track_step(jnp.asarray(K), **STEP_KW)
    ts = interop.track_state_from_numpy(np_state, "cpu", seed=0)
    js = jstate
    for i in (1, 2):
        js, jo = jstep(js, jnp.asarray(frames[i]))
        ts, to = tstep(ts, torch.from_numpy(frames[i]))
        T_j, T_t = np.asarray(jo.T_w2c), to.T_w2c.numpy()
        assert int(to.n_inliers) >= 20, (i, int(to.n_inliers))
        assert int(to.guided_valid.sum()) > 0  # the local map took part
        for T in (T_t, T_j):
            np.testing.assert_allclose(T[:3, :3], Ts[i][:3, :3], atol=R_ATOL)
            np.testing.assert_allclose(T[:3, 3], Ts[i][:3, 3], atol=T_ATOL)
        np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=R_ATOL)
        np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=T_ATOL)
        assert to.features.desc.dtype == torch.int32 and to.features.xy.shape == (NF, 2)


def test_chunk_equals_single_steps(setup, tstep):
    """make_track_chunk over 4 frames equals 4 single steps run with the
    same generator seed, leaf for leaf."""
    K, frames, Ts, _, np_state = setup
    imgs = torch.from_numpy(np.stack(frames[1:5]))
    s1 = interop.track_state_from_numpy(np_state, "cpu", seed=7)
    s1, outs = tp.make_track_chunk(tstep)(s1, imgs)
    s2 = interop.track_state_from_numpy(np_state, "cpu", seed=7)
    for c in range(4):
        s2, o = tstep(s2, imgs[c])
        assert torch.equal(outs.T_w2c[c], o.T_w2c)
        assert torch.equal(outs.pnp_inliers[c], o.pnp_inliers)
        assert torch.equal(outs.guided_idx[c], o.guided_idx)
        assert torch.equal(outs.features.desc[c], o.features.desc)
    assert outs.features.xy.shape == (4, NF, 2) and outs.n_inliers.shape == (4,)
    assert torch.equal(s1.T_w2c, s2.T_w2c) and torch.equal(s1.T_rel, s2.T_rel)
    for c in range(2):
        np.testing.assert_allclose(outs.T_w2c[c, :3, 3].numpy(), Ts[c + 1][:3, 3], atol=T_ATOL)


def test_swap_reference_and_local_map(setup, tstep):
    K, frames, Ts, _, np_state = setup
    s = interop.track_state_from_numpy(np_state, "cpu")
    s, out = tstep(s, torch.from_numpy(frames[1]))
    s2 = tp.swap_reference(s, out.features, s.ref_landmarks, s.ref_has_landmark)
    assert s2.ref_feats.xy.shape == s.ref_feats.xy.shape
    s3 = tp.set_local_map(s2, np.zeros((M, 3)), np.zeros((M, 8), np.int32), np.zeros(M, bool))
    s4, out4 = tstep(s3, torch.from_numpy(frames[2]))
    assert not bool(out4.guided_valid.any())  # an empty arena matches nothing
    assert torch.isfinite(out4.T_w2c).all()


def test_init_track_state_and_stereo_refused(setup):
    K = setup[0]
    feats = interop.features_from_numpy(setup[4].ref_feats)
    s = tp.init_track_state(feats, np.zeros((NF, 3)), np.zeros(NF, bool), np.eye(4), local_map_size=M)
    assert s.lm_desc.shape == (M, 8) and s.lm_desc.dtype == torch.int32 and not bool(s.lm_valid.any())
    assert torch.equal(s.T_rel, torch.eye(4))
    # The stereo step is ported; as in the JAX package it needs a positive baseline.
    with pytest.raises(ValueError, match="baseline"):
        tp.make_track_step(K, stereo=True, device="cpu")
