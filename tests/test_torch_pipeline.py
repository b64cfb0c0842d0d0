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


# ------------------------------------ the fallback at a degraded frame (ROADMAP F7)
KF = 718.856  # a KITTI-width camera, as the stereo pipeline's world
K_KITTI = np.array([[KF, 0, 620.0], [0, KF, 188.0], [0, 0, 1.0]], np.float32)


def _degraded_frame(seed: int, stereo: bool, n_in: int = 30, n_out: int = 150):
    """A frame 2.4 m ahead of a reference block whose landmarks mostly
    carry depth errors (15-50 %, either sign), as a stereo block four pairs
    old does: ``n_in`` exact landmarks, ``n_out`` displaced ones, the
    observations from the true pose with 0.3 px noise, and the true pose
    as the prediction. With ``stereo``, half the points carry a measured
    depth (1 % noise). Returns (pts3d, xy_norm, valid, T_pred, depth)."""
    rng = np.random.default_rng(seed)
    n = n_in + n_out
    Z = rng.uniform(6.0, 40.0, n)
    P = np.stack([rng.uniform(-0.6, 0.6, n) * (Z - 2.4), rng.uniform(-0.2, 0.2, n) * (Z - 2.4), Z], 1)
    Pm = P.copy()
    Pm[n_in:] *= 1.0 + (rng.choice([-1.0, 1.0], n_out) * rng.uniform(0.15, 0.5, n_out))[:, None]
    T = np.eye(4)
    T[2, 3] = -2.4
    pc = P + T[:3, 3]
    xy = pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.3 / KF, (n, 2))
    depth = None
    if stereo:
        z = pc[:, 2] * (1 + rng.normal(0, 0.01, n))
        depth = (torch.tensor(z, dtype=torch.float32), torch.tensor(rng.random(n) < 0.5), 0.54)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return f32(Pm), f32(xy), torch.ones(n, dtype=torch.bool), f32(T), depth


@pytest.mark.parametrize("stereo", [False, True])
def test_solve_keeps_the_predictions_inliers(stereo):
    """A degraded frame (ROADMAP F7: 30 of 180 pairs inliers, the rest
    landmarks with depth errors), over six worlds: the port's solve returns
    a pose holding at least the inliers its prediction holds, in every
    world. The JAX step's fallback, Gauss-Newton from the prediction over
    every pair (its ``refine_pose_gn`` or ``refine_pose_gn_depth``), ends
    with fewer inliers than its start in some of them, and so does the
    port's RANSAC. Each RANSAC draws only displaced landmarks: at 1 in 6
    pairs a clean 6-point sample is a 1e-5 draw."""
    from visual_slam_tpu.ops import pnp as jpnp
    from visual_slam_tpu_torch.ops.epipolar import _sample_minimal_sets
    from visual_slam_tpu_torch.ops.pnp import _reproj_err2, ransac_pnp

    step = tp.make_track_step(K_KITTI, device="cpu", pnp_hypotheses=128)
    t2 = step.thresh * step.thresh
    jax_lost = ransac_lost = 0
    for seed in range(6):
        P, xy, valid, T, depth = _degraded_frame(seed, stereo)
        idx = 30 + _sample_minimal_sets(torch.Generator().manual_seed(seed), valid[30:], 128, 6)

        def n_inl(R, t):
            return int(((_reproj_err2(torch.tensor(np.array(R)), torch.tensor(np.array(t)), P, xy) < t2)
                        & valid).sum())

        n_pred = n_inl(T[:3, :3], T[:3, 3])
        T_s, inl = step.solve_pose(P, xy, valid, T, None, sample_idx=idx, depth=depth)
        assert int(inl.sum()) >= n_pred, (seed, int(inl.sum()), n_pred)
        assert int(inl.sum()) == n_inl(T_s[:3, :3], T_s[:3, 3])
        j = [jnp.asarray(a.numpy()) for a in (T[:3, :3], T[:3, 3], P, xy, valid.to(torch.float32))]
        if stereo:
            z, z_ok, b = depth
            R_j, t_j = jpnp.refine_pose_gn_depth(*j, jnp.asarray(z.numpy()), jnp.asarray(z_ok.numpy(), jnp.float32),
                                                 b, iters=8, huber=float(step.thresh))
            d = {"z_meas": z, "z_valid": z_ok, "baseline": b}
        else:
            R_j, t_j = jpnp.refine_pose_gn(*j, iters=8, huber=float(step.thresh))
            d = {}
        jax_lost += n_inl(R_j, t_j) < n_pred
        res = ransac_pnp(P, xy, valid, None, n_hyp=128, thresh=step.thresh, sample_idx=idx, **d)
        ransac_lost += int(res["n_inliers"]) < n_pred
    assert jax_lost >= 1 and ransac_lost >= 1, (jax_lost, ransac_lost)
