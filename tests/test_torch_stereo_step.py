"""The port's stereo tracking step (``make_track_step(stereo=True)``) and its
entry points against the JAX package's, on the CPU.

The world is tests/test_pipeline.py::test_stereo_track_step's: the sprite
world of ``render.make_world`` (seed 4) seen by a rectified rig with a
0.4 m baseline (``render.stereo_pair``), 320x240, f = 260, 256 features,
2 levels, grid 4, frame-0 landmarks from the z-buffer. Both packages' steps
track frames 1-3 from the same state (the port's carried over from JAX's
bit for bit), and:
- each frame holds the JAX test's bounds in both packages: >= 15 inliers,
  >= 30 depth-valid slots, translation error < 0.12 m, median relative
  depth error < 0.05 against the z-buffer; each pose within
  tests/test_torch_pipeline.py's R_ATOL / T_ATOL of JAX's (RANSAC draws
  differ: torch cannot reproduce JAX's random bits);
- on the JAX package's features the step's depth rule gives JAX's
  depth-valid slots exactly (JAX's gate: z > min_depth, no upper bound)
  and its depths to 1e-6 relative; on the port's own features it gives
  them exactly on every slot whose row and disparity gate reaches only
  keypoints whose descriptors agree in both packages (the right camera's
  candidates, and the left keypoints that compete with it for them in the
  cross-check): a few per cent of the slots here, as the packages'
  descriptors differ at near ties (tests/test_torch_descriptor_ties.py);
  over all valid slots the sets agree on >= MIN_SLOT_AGREEMENT;
- fed the JAX step's inputs and its RANSAC draws (``sample_idx``), the
  port's depth-aware pose solve gives JAX's pose within 1e-4 and its
  inliers exactly;
- ``make_track_chunk`` over (C, 2, H, W) pairs equals C single steps; the
  batched stereo step (``make_batched_vo(stereo=True)``, ``BatchedVO``)
  equals one single step at B = 1 exactly but for the pose (1e-5: the
  batched solve's small products round otherwise), and two at B = 2 within
  R_ATOL / T_ATOL (a batch of four frames rounds its BRIEF product
  otherwise);
  ``CompiledVO(stereo=True)`` equals the step; batched
  ``stereo_feature_depths`` equals the unbatched one exactly;
- ``stereo=True`` without a positive baseline raises ``ValueError`` in
  every entry point, as in the JAX package.

The ``cuda`` case runs the stereo step on the card against its own CPU run
(one batched K1 launch a step for the pair) and skips here; JAX is
imported inside the fixtures that compare with it, so it also runs where
only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_stereo_step.py``.
"""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import pipeline as tp
from visual_slam_tpu_torch.models.families import BatchedVO, CompiledVO
from visual_slam_tpu_torch.ops import stereo as tst
from visual_slam_tpu_torch.ops.projection import normalize_points
from visual_slam_tpu_torch.parallel import make_batched_vo

from render import camera_path, make_world, render_with_depth, stereo_pair

torch.set_num_threads(1)

NF, W, H, F, BL = 256, 320, 240, 260.0, 0.4
N_FRAMES = 4
STEP_KW = dict(num_features=NF, fast_threshold=12.0, n_levels=2, grid=4, pnp_hypotheses=64)
R_ATOL, T_ATOL = 0.01, 0.06  # tests/test_torch_pipeline.py's bounds on poses
MIN_SLOT_AGREEMENT = 0.9
POSE_B1_ATOL = 1e-5
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)


def zbuf_landmarks(xy, valid, zbuf):
    Kinv = np.linalg.inv(K)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and zbuf[v, u] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * float(zbuf[v, u])
            has[i] = True
    return lm, has


def depth_errors(out, zbuf):
    """Relative errors of the step's depth-valid slots against the z-buffer."""
    kz, kv, xy = (np.asarray(x) for x in (out.kp_z, out.kp_z_valid, out.features.xy))
    errs = []
    for i in np.nonzero(kv)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and zbuf[v, u] > 0.5:
            errs.append(abs(kz[i] - zbuf[v, u]) / zbuf[v, u])
    return np.asarray(errs)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(4)
    w = make_world(rng)
    Ts = camera_path(N_FRAMES, step=0.3)
    pairs = np.stack([np.stack(stereo_pair(w, T, K, BL, W, H)) for T in Ts]).astype(np.float32)
    zbufs = np.stack([render_with_depth(w, T, K, W, H)[1] for T in Ts])
    return Ts, pairs, zbufs


@pytest.fixture(scope="module")
def jax_run(world):
    """The JAX step over frames 1-3 from its frame-0 state: the numpy
    state before each step, each output, and each frame's right features."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu import pipeline as jp
    from visual_slam_tpu.ops.detector import detect_and_describe

    Ts, pairs, zbufs = world
    det = dict(num_features=NF, threshold=12.0, n_levels=2, grid=4)
    f0 = detect_and_describe(jnp.asarray(pairs[0, 0]), **det)
    lm, has = zbuf_landmarks(np.asarray(f0.xy), np.asarray(f0.valid), zbufs[0])
    state = jp.init_track_state(f0, lm, has, np.eye(4))
    step = jp.make_track_step(jnp.asarray(K), stereo=True, baseline=BL, **STEP_KW)
    states, outs, rights = [], [], []
    for i in range(1, N_FRAMES):
        states.append(jax.tree_util.tree_map(np.asarray, state))
        state, out = step(state, jnp.asarray(pairs[i]))
        outs.append(jax.tree_util.tree_map(np.asarray, out))
        rights.append(jax.tree_util.tree_map(np.asarray, detect_and_describe(jnp.asarray(pairs[i, 1]), **det)))
    return states, outs, rights


@pytest.fixture(scope="module")
def tstep():
    return tp.make_track_step(K, stereo=True, baseline=BL, device="cpu", **STEP_KW)


@pytest.fixture(scope="module")
def port_run(world, jax_run, tstep):
    """The port's step over frames 1-3 from JAX's frame-0 state."""
    _, pairs, _ = world
    s = interop.track_state_from_numpy(jax_run[0][0], "cpu", seed=0)
    outs = []
    for i in range(1, N_FRAMES):
        s, out = tstep(s, torch.from_numpy(pairs[i]))
        outs.append(out)
    return outs


def test_stereo_step_matches_jax_and_ground_truth(world, jax_run, port_run):
    Ts, _, zbufs = world
    for i, (jo, to) in enumerate(zip(jax_run[1], port_run), 1):
        for name, o in (("jax", jo), ("port", to)):
            T = np.asarray(o.T_w2c)
            assert int(o.n_inliers) >= 15, (name, i, int(o.n_inliers))
            assert int(np.asarray(o.kp_z_valid).sum()) >= 30, (name, i)
            t_err = np.linalg.norm(T[:3, 3] - Ts[i][:3, 3])
            assert t_err < 0.12, (name, i, t_err)
            errs = depth_errors(o, zbufs[i])
            assert len(errs) >= 20 and np.median(errs) < 0.05, (name, i, len(errs), np.median(errs))
        T_j, T_t = np.asarray(jo.T_w2c), to.T_w2c.numpy()
        np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=R_ATOL)
        np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=T_ATOL)
        assert to.kp_z.dtype == torch.float32 and to.kp_z_valid.dtype == torch.bool
        assert to.kp_z.shape == (NF,) and to.features.xy.shape == (NF, 2)
        assert not bool(to.guided_valid.any())  # no local map: zeros, as JAX's


def _agree(jf, tf):
    """Slots where the JAX package's features ``jf`` (numpy) and the port's
    ``tf`` hold the same keypoint with the same descriptor."""
    same_kp = (jf.valid == tf.valid.numpy()) & (jf.xy == tf.xy.numpy()).all(-1)
    return same_kp & (jf.desc == interop.desc_to_uint32(tf.desc)).all(-1)


def test_depth_valid_slots_equal_jax(world, jax_run, tstep):
    """The step's depth rule (``TrackStep.stereo_depths``: the row-gated
    match passes and z > min_depth, no upper bound) on the JAX package's
    left and right features gives JAX's depth-valid slots exactly and its
    depths to 1e-6 relative, on every slot. On the port's own features (a
    pair detected as one batch) it gives JAX's slot set exactly wherever
    the gate reaches only keypoints whose descriptors agree in both
    packages: each gated right candidate, and every left keypoint that
    competes with slot i for one of them in the cross-check. Only about
    30 % of the descriptors agree in all 256 bits here (98.8 % of the bits
    do; flat sprites tie BRIEF's comparisons), so that holds for a few
    per cent of the valid slots, 5-8 a frame; over all valid slots the
    two sets agree on at least MIN_SLOT_AGREEMENT."""
    _, pairs, _ = world
    for i, (jo, jr) in enumerate(zip(jax_run[1], jax_run[2]), 1):
        jl = jo.features
        z, z_ok = tstep.stereo_depths(interop.features_from_numpy(jl), interop.features_from_numpy(jr))
        np.testing.assert_array_equal(z_ok.numpy(), jo.kp_z_valid)
        np.testing.assert_allclose(z.numpy()[jo.kp_z_valid], jo.kp_z[jo.kp_z_valid], rtol=1e-6)

        fl, fr = tstep.detect_pair(torch.from_numpy(pairs[i]))
        z, z_ok = tstep.stereo_depths(fl, fr)
        eq_l, eq_r = _agree(jl, fl), _agree(jr, fr)
        # The gate on JAX's keypoints (the same positions where eq holds).
        dv = np.abs(jl.xy[:, None, 1] - jr.xy[None, :, 1])
        disp = jl.xy[:, None, 0] - jr.xy[None, :, 0]
        gate = (dv <= 2.0) & (disp > 0.1) & (disp < F * BL / 0.1) & jl.valid[:, None] & jr.valid[None, :]
        # Row i reads its gated right candidates; the cross-check reads, for
        # each of them, every left keypoint gated to it.
        rows_ok = ~(gate & ~eq_r[None, :]).any(1)
        cols_ok = ~(gate & ~eq_l[:, None]).any(0)
        clean = eq_l & rows_ok & ~(gate & ~cols_ok[None, :]).any(1)
        assert clean.sum() >= 3, (i, int(clean.sum()))
        np.testing.assert_array_equal(z_ok.numpy()[clean], jo.kp_z_valid[clean])
        np.testing.assert_allclose(z.numpy()[clean & jo.kp_z_valid], jo.kp_z[clean & jo.kp_z_valid], rtol=1e-6)
        agreement = (z_ok.numpy() == jo.kp_z_valid)[jl.valid].mean()
        assert agreement >= MIN_SLOT_AGREEMENT, (i, agreement)


def test_depth_pose_solve_matches_jax_with_its_draws(world, jax_run, tstep):
    """The JAX step's pairs, depths and RANSAC draws through the port's
    depth-aware solve (RANSAC-PnP with the depth residual, the Gauss-Newton
    fallback and the choice between them): JAX's pose within 1e-4 and its
    inliers exactly."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops.epipolar import _sample_minimal_sets

    for js, jo in zip(*jax_run[:2]):
        pair_valid = jo.match_valid & js.ref_has_landmark[jo.match_train_idx]
        pts3d = js.ref_landmarks[jo.match_train_idx]
        _, sub = jax.random.split(jnp.asarray(js.key))
        idx = _sample_minimal_sets(sub, jnp.asarray(pair_valid), STEP_KW["pnp_hypotheses"], 6)
        T_pred = torch.tensor(js.T_rel @ js.T_w2c)
        xy_n = normalize_points(tstep.Kinv, torch.tensor(jo.features.xy))
        depth = (torch.tensor(jo.kp_z), torch.tensor(jo.kp_z_valid), BL)
        T, inl = tstep.solve_pose(torch.tensor(pts3d), xy_n, torch.tensor(pair_valid), T_pred, None,
                                  sample_idx=torch.tensor(np.asarray(idx)), depth=depth)
        np.testing.assert_allclose(T.numpy(), jo.T_w2c, atol=1e-4)
        np.testing.assert_array_equal(inl.numpy(), jo.pnp_inliers)


def test_chunk_of_pairs_equals_single_steps(world, jax_run, tstep):
    _, pairs, _ = world
    imgs = torch.from_numpy(pairs[1:])
    s1 = interop.track_state_from_numpy(jax_run[0][0], "cpu", seed=7)
    s1, outs = tp.make_track_chunk(tstep)(s1, imgs)
    s2 = interop.track_state_from_numpy(jax_run[0][0], "cpu", seed=7)
    for c in range(len(imgs)):
        s2, o = tstep(s2, imgs[c])
        for a, b in zip(tp.split_track_outputs(outs)[c], o):
            assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(b, tuple) else torch.equal(a, b)
    assert outs.kp_z.shape == (len(imgs), NF) and outs.features.xy.shape == (len(imgs), NF, 2)
    assert torch.equal(s1.T_w2c, s2.T_w2c) and torch.equal(s1.T_rel, s2.T_rel)


def _port_state(jax_run, seed):
    return interop.track_state_from_numpy(jax_run[0][0], "cpu", seed=seed)


def test_batched_stereo_step_at_one_equals_the_single_step(world, jax_run, tstep):
    """Every output exactly, features, matches, depths and inliers included,
    but the pose: the batched solve's small products round otherwise in the
    last bits (tests/test_torch_multiseq.py), POSE_B1_ATOL."""
    _, pairs, _ = world
    bstep = make_batched_vo(K, device="cpu", stereo=True, baseline=BL, **STEP_KW)
    sb = tp.stack_track_states([_port_state(jax_run, 3)])
    s = _port_state(jax_run, 3)
    for i in range(1, N_FRAMES):
        sb, ob = bstep(sb, torch.from_numpy(pairs[i:i + 1]))
        s, o = tstep(s, torch.from_numpy(pairs[i]))
        for name, a, b in zip(o._fields, tp.split_track_outputs(ob)[0], o):
            if name == "T_w2c":
                torch.testing.assert_close(a, b, rtol=0, atol=POSE_B1_ATOL)
            else:
                assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(b, tuple) else torch.equal(a, b)
    torch.testing.assert_close(sb.T_w2c[0], s.T_w2c, rtol=0, atol=POSE_B1_ATOL)


def test_batched_stereo_step_at_two_matches_single_steps(world, jax_run, tstep):
    """Two sequences (the world's frames in order, and its frames 1-3
    again with the second generator seed) through make_batched_vo and
    BatchedVO against two single steps with the same seeds."""
    Ts, pairs, _ = world
    bstep = make_batched_vo(K, device="cpu", stereo=True, baseline=BL, **STEP_KW)
    vo = BatchedVO(K, device="cpu", stereo=True, baseline=BL, **STEP_KW)
    sb = tp.stack_track_states([_port_state(jax_run, b) for b in range(2)])
    sv = tp.stack_track_states([_port_state(jax_run, b) for b in range(2)])
    singles = [_port_state(jax_run, b) for b in range(2)]
    for i in range(1, N_FRAMES):
        imgs = torch.from_numpy(np.stack([pairs[i], pairs[i]]))
        sb, ob = bstep(sb, imgs)
        sv, ov = vo.track(sv, imgs.numpy())
        assert torch.equal(ob.T_w2c, ov.T_w2c) and torch.equal(ob.kp_z_valid, ov.kp_z_valid)
        assert ob.kp_z.shape == (2, NF) and ob.features.desc.shape == (2, NF, 8)
        for b in range(2):
            singles[b], o = tstep(singles[b], imgs[b])
            T_b, T_1 = ob.T_w2c[b].numpy(), o.T_w2c.numpy()
            assert int(ob.n_inliers[b]) >= 15
            np.testing.assert_allclose(T_b[:3, :3], T_1[:3, :3], atol=R_ATOL)
            np.testing.assert_allclose(T_b[:3, 3], T_1[:3, 3], atol=T_ATOL)
            assert np.linalg.norm(T_b[:3, 3] - Ts[i][:3, 3]) < 0.12
            assert abs(int(ob.kp_z_valid[b].sum()) - int(o.kp_z_valid.sum())) <= 3
    with pytest.raises(ValueError, match="pairs"):
        bstep(sb, imgs[:, 0])  # frames, not pairs
    with pytest.raises(ValueError):
        bstep(sb, imgs[:1])  # one pair for two generators


def test_compiled_vo_stereo_equals_the_step(world, jax_run, tstep):
    _, pairs, _ = world
    js = jax_run[0][0]
    vo = CompiledVO(K, device="cpu", stereo=True, baseline=BL, **STEP_KW)
    vo.set_reference(interop.features_from_numpy(js.ref_feats), np.array(js.ref_landmarks),
                     np.array(js.ref_has_landmark), seed=5)
    s = _port_state(jax_run, 5)
    for i in range(1, N_FRAMES):
        res = vo.track(pairs[i])
        s, o = tstep(s, torch.from_numpy(pairs[i]))
        np.testing.assert_array_equal(res["T_w2c"], o.T_w2c.numpy())
        assert res["n_inliers"] == int(o.n_inliers)


def test_batched_stereo_feature_depths_equal_unbatched(world, tstep):
    """B = 3 pairs, the third with no valid right keypoint: each exactly as
    alone, and B = 1 exactly as the unbatched call; ``detect_pair`` gives
    each camera's features as contiguous tensors."""
    _, pairs, _ = world
    fl, fr = tstep.detect_pair(torch.from_numpy(pairs[1:4]))
    # Each camera of B pairs comes out dense: the card's kernels take only contiguous rows.
    assert all(a.is_contiguous() for a in fl + fr)
    fr = fr._replace(valid=fr.valid.clone())
    fr.valid[2] = False
    args = (fl.xy, fl.desc, fl.valid, fr.xy, fr.desc, fr.valid)
    kw = dict(row_tolerance=2.0, max_disparity=F * BL / 0.1)
    batched = tst.stereo_feature_depths(*args, F * BL, **kw)
    for b in range(3):
        one = tst.stereo_feature_depths(*[a[b] for a in args], F * BL, **kw)
        for key in ("z", "disparity", "right_idx", "valid"):
            assert torch.equal(batched[key][b], one[key]), (b, key)
        b1 = tst.stereo_feature_depths(*[a[b:b + 1] for a in args], F * BL, **kw)
        assert all(torch.equal(b1[key][0], one[key]) for key in one)
    assert int(batched["valid"][0].sum()) >= 30 and not bool(batched["valid"][2].any())


def test_stereo_without_baseline_raises():
    jp = pytest.importorskip("visual_slam_tpu.pipeline")
    with pytest.raises(ValueError):
        jp.make_track_step(np.asarray(K), stereo=True)
    for make in (lambda: tp.make_track_step(K, stereo=True, device="cpu"),
                 lambda: tp.make_track_step(K, stereo=True, baseline=-0.1, device="cpu"),
                 lambda: CompiledVO(K, stereo=True, device="cpu"),
                 lambda: make_batched_vo(K, stereo=True, device="cpu")):
        with pytest.raises(ValueError, match="baseline"):
            make()
    # With a baseline, the self-promoting chunk takes the stereo step (it
    # raised before stereo promotion was ported).
    chunk = tp.make_track_chunk_promote(tp.make_track_step(K, stereo=True, baseline=BL, device="cpu"), K, stereo=True)
    assert chunk.stereo and chunk.step.stereo


@pytest.mark.cuda
def test_stereo_step_cuda_against_its_cpu_run(world):
    """The stereo step on the card over frames 1-3: one batched K1 launch a
    step for the pair (none of the one-frame K1), one K2 launch; each pose
    within R_ATOL / T_ATOL of the same step run on the CPU through the
    plain versions, and the depth-valid counts within 3 % of the CPU's.
    Then the batched stereo step at B = 2 on the card: one batched K1
    launch (four frames) and one paired K2 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels

    Ts, pairs, zbufs = world
    cpu_step = tp.make_track_step(K, stereo=True, baseline=BL, device="cpu", **STEP_KW)
    f0 = cpu_step.detect(torch.from_numpy(pairs[0, 0]))
    lm, has = zbuf_landmarks(f0.xy.numpy(), f0.valid.numpy(), zbufs[0])
    steps = {d: tp.make_track_step(K, stereo=True, baseline=BL, device=d, **STEP_KW) for d in ("cpu", "cuda")}
    states = {d: tp.init_track_state(f0, lm, has, np.eye(4), seed=0, device=d) for d in ("cpu", "cuda")}
    counters = (patches_and_moments_batched, patches_and_moments_levels, mk.hamming_top2)
    before = [c.launches for c in counters]
    for i in range(1, N_FRAMES):
        outs = {}
        for d in ("cpu", "cuda"):
            states[d], outs[d] = steps[d](states[d], torch.from_numpy(pairs[i]).to(d))
        T_c, T_g = outs["cpu"].T_w2c.numpy(), outs["cuda"].T_w2c.cpu().numpy()
        np.testing.assert_allclose(T_g[:3, :3], T_c[:3, :3], atol=R_ATOL)
        np.testing.assert_allclose(T_g[:3, 3], T_c[:3, 3], atol=T_ATOL)
        n_c, n_g = int(outs["cpu"].kp_z_valid.sum()), int(outs["cuda"].kp_z_valid.sum())
        assert n_g >= 30 and abs(n_g - n_c) <= 0.03 * n_c, (n_g, n_c)
        assert int(outs["cuda"].n_inliers) >= 15
    assert [c.launches - n for c, n in zip(counters, before)] == [N_FRAMES - 1, 0, N_FRAMES - 1]
    bstep = make_batched_vo(K, device="cuda", stereo=True, baseline=BL, **STEP_KW)
    sb = tp.stack_track_states([tp.init_track_state(f0, lm, has, np.eye(4), seed=b, device="cuda") for b in range(2)])
    before = (patches_and_moments_batched.launches, mk.hamming_top2_paired.launches)
    _, ob = bstep(sb, torch.from_numpy(np.stack([pairs[1], pairs[1]])).cuda())
    assert (patches_and_moments_batched.launches - before[0], mk.hamming_top2_paired.launches - before[1]) == (1, 1)
    assert (ob.n_inliers.cpu() >= 15).all() and (ob.kp_z_valid.sum(-1).cpu() >= 30).all()
