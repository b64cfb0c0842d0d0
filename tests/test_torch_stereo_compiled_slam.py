"""The port's stereo ``CompiledSLAM`` (``camera.sensor_type = "stereo"``)
against the JAX package's, on the CPU, through the three routes by which
JAX's reaches a keyframe.

- The self-promoting chunk (``make_track_chunk_promote(stereo=True)``)
  against JAX's on identical step outputs (tests/test_torch_promote.py's
  stub step, with prepared depths: depth-invalid slots, depths beyond
  ``max_depth``, inherited slots, invalid keypoints with a depth, a padded
  flush frame): ``promoted``, ``ref_has`` and ``ref_tri`` exact,
  ``ref_pos`` to 1e-5.
- ``_create_stereo_points`` against JAX's on the same keyframe and step
  output: the same slots minted, positions to 1e-9 (float64 numpy in
  both), the same ``kp_z_valid``.
- Whole runs (tests/stereo_pipeline_world.py's small worlds: the JAX stereo
  tests' 320x240 sprite worlds, 0.5 m baseline, metric ATE without scale
  alignment), each from the port's own one-pair bootstrap at one torch
  thread: single frame (JAX ``test_compiled_slam_stereo``: OK, ATE < 0.35,
  more than 50 landmarks), device promotion (JAX
  ``test_compiled_slam_stereo_device_promotion``: OK, ATE < 0.25, at least
  3 keyframes, at least 14 frames tracked) and plain chunks of 4 on the
  device-promotion world (both packages held to its bound; at 7, past the
  world's match-decay horizon for a fixed reference, the first boundary's
  choice turns on one frame's inliers either side of ``min_inliers``); a
  blank pair
  goes LOST and the next one relocalizes; the host promotions' double mint
  (a triangulated landmark written over a disparity landmark's slot, as in
  the JAX package) is counted by ``stereo_pipeline_world.Probe``.
- ``_img_buf`` / ``_img_arg`` take ``[left, right]``; one image raises
  ``ValueError`` with JAX's message.

The ``cuda`` case runs the device-promotion world on the card against its
own CPU run and skips here; JAX is imported only inside the fixtures and
tests that compare with it, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_stereo_compiled_slam.py``.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import stereo_pipeline_world as spw
from visual_slam_tpu_torch import pipeline as tpl
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse

BOUNDS = {"single": 0.35, "promotion": 0.25, "plain": 0.25}  # metric ATE (m), the JAX tests' bounds
BLANK = 5  # the pair blanked out in the relocalization run


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _run(world: str, device="cpu", blank=None, slam_cls=None, camera_cls=None, config_cls=None):
    """One small world through a stereo ``CompiledSLAM`` (the port's unless
    classes are given), pair by pair from its own bootstrap, then
    ``shutdown()``. Returns (slam, infos, probe, metric ATE m)."""
    slam_cls, camera_cls, config_cls = slam_cls or CompiledSLAM, camera_cls or PinholeCamera, config_cls or Config
    lefts, rights, K, Ts = spw.small_frames(world)
    kw = {} if slam_cls is not CompiledSLAM else {"device": device}
    slam = slam_cls(spw.camera(camera_cls, lefts, K, spw.SMALL_BASELINE), spw.small_config(config_cls, world), **kw)
    assert slam._stereo
    probe = spw.Probe(slam)
    infos = []
    for i, (left, right) in enumerate(zip(lefts, rights)):
        if i == blank:
            left, right = np.zeros_like(left), np.zeros_like(right)
        infos.append(slam.track([left, right], timestamp=i * spw.DT))
    slam.shutdown()
    ts, T = slam.trajectory()
    return slam, infos, probe, spw.metric_ate(ate_rmse, ts, T, Ts)[0]


@pytest.fixture(scope="module")
def runs():
    with _threads(1):
        out = {w: _run(w) for w in ("single", "promotion", "plain")}
        out["reloc"] = _run("single", blank=BLANK)
    return out


# ----------------------------------------------------- the self-promoting chunk
@pytest.fixture(scope="module")
def stereo_scene():
    """tests/test_torch_promote.py's kind of scene (keypoint slot i of every
    frame sees world point i; the camera slides 0.3 m a frame; a third of
    the reference slots carry landmarks, some keypoints match through the
    arena, a few matches are gross outliers, and the inlier counts walk
    through every gate) with per-keypoint depths: the true depth with 1 %
    noise, a fifth of the slots without a valid depth, the four invalid
    keypoints with one, and points out to 12 m against GATES' 9 m
    ``max_depth``."""
    import jax
    import jax.numpy as jnp
    from test_torch_promote import KMAT, NA, NK, _feats, _pose

    from visual_slam_tpu import pipeline as jpl

    C = 6
    rng = np.random.default_rng(3)
    X = np.stack([rng.uniform(-3, 3, NK), rng.uniform(-2, 2, NK), rng.uniform(4, 12, NK)], 1)

    def project(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return (pc[:, :2] / pc[:, 2:3]) * KMAT[0, 0] + KMAT[:2, 2] + rng.normal(0, 0.2, (NK, 2)), pc[:, 2]

    T_ref = _pose(0.0)
    ref_feats = _feats(rng, project(T_ref)[0])
    has = np.arange(NK) % 3 == 0
    ref_lm = np.where(has[:, None], X + rng.normal(0, 0.01, X.shape), 0.0).astype(np.float32)
    lm_pos = np.zeros((NA, 3), np.float32)
    lm_pos[:20] = X[1:41:2] + rng.normal(0, 0.01, (20, 3))
    state = jpl.TrackState(
        ref_feats=ref_feats, ref_landmarks=jnp.asarray(ref_lm), ref_has_landmark=jnp.asarray(has),
        T_w2c=jnp.asarray(T_ref), T_rel=jnp.eye(4, dtype=jnp.float32), key=jax.random.PRNGKey(0),
        lm_pos=jnp.asarray(lm_pos), lm_desc=jnp.zeros((NA, 8), jnp.uint32), lm_valid=jnp.asarray(np.arange(NA) < 20),
    )
    n_inl = [60, 55, 30, 8, 50, 45]  # frame 3 is too weak to promote
    outs = []
    for c in range(C):
        T = _pose(0.3 * (c + 1), yaw=0.01 * c)
        xy, z = project(T)
        xy[rng.choice(NK, 3, replace=False)] += 25.0
        m_ok = rng.random(NK) > 0.15
        inl = m_ok & (rng.random(NK) > 0.1)
        g_ok = np.zeros(NK, bool)
        g_idx = np.zeros(NK, np.int32)
        odd = np.arange(1, 41, 2)
        g_ok[odd] = rng.random(20) > 0.3
        g_idx[odd] = np.arange(20)
        z_ok = rng.random(NK) > 0.2
        z_ok[-4:] = True  # invalid keypoints with a valid depth: the features' gate drops them
        outs.append(jpl.TrackOutput(
            T_w2c=jnp.asarray(T), n_inliers=jnp.int32(n_inl[c]), n_matches=jnp.int32(int(m_ok.sum())),
            features=_feats(rng, xy), match_train_idx=jnp.arange(NK, dtype=jnp.int32),
            match_valid=jnp.asarray(m_ok), pnp_inliers=jnp.asarray(inl),
            guided_idx=jnp.asarray(g_idx), guided_valid=jnp.asarray(g_ok),
            kp_z=jnp.asarray(z * (1 + rng.normal(0, 0.01, NK)), jnp.float32), kp_z_valid=jnp.asarray(z_ok),
        ))
    return state, jax.tree.map(lambda *a: jnp.stack(a), *outs), T_ref


GATES = dict(min_inliers=10, keyframe_interval=2, kf_min_matches=40, kf_min_rotation_deg=10.0,
             kf_min_translation=1.0, min_depth=0.1, max_depth=9.0, min_parallax_deg=0.5, pnp_threshold_px=3.0)


@pytest.mark.parametrize("n_valid", [6, 4])
def test_stereo_chunk_promote_matches_jax(stereo_scene, n_valid):
    import jax.numpy as jnp
    from test_torch_promote import KMAT, _JaxStub, _TorchStub

    from visual_slam_tpu import pipeline as jpl
    from visual_slam_tpu_torch.interop import track_output_from_numpy, track_state_from_numpy

    state, outs, T_ref = stereo_scene
    C = outs.n_inliers.shape[0]
    jchunk = jpl.make_track_chunk_promote(_JaxStub(outs), jnp.asarray(KMAT), stereo=True, **GATES)
    js, jfsr, jT, _, jrecs = jchunk(state, 0, T_ref, jnp.arange(C, dtype=jnp.int32), n_valid=n_valid)
    tchunk = tpl.make_track_chunk_promote(_TorchStub(track_output_from_numpy(outs)), KMAT, stereo=True, **GATES)
    ts, tfsr, tT, _, trecs = tchunk(track_state_from_numpy(state), 0, T_ref, torch.arange(C), n_valid=n_valid)

    promoted = np.asarray(jrecs.promoted)
    assert promoted.tolist() == [False, False, True, False, False, True][:n_valid] + [False] * (C - n_valid)
    # The scene reaches every gate on the promoted frames.
    for f in np.nonzero(promoted)[0]:
        valid, z_ok = np.asarray(outs.features.valid[f]), np.asarray(outs.kp_z_valid[f])
        z, tri, has = np.asarray(outs.kp_z[f]), np.asarray(jrecs.ref_tri[f]), np.asarray(jrecs.ref_has[f])
        inherited = has & ~tri
        assert tri.any() and inherited.any()
        assert (valid & ~inherited & ~z_ok).any()  # no valid depth
        assert (valid & ~inherited & z_ok & (z >= GATES["max_depth"])).any()  # beyond max_depth
        assert (~valid & z_ok).any() and not tri[~valid].any()  # invalid keypoints with a depth
        assert (inherited & z_ok).any()  # inherited slots keep their landmark
    np.testing.assert_array_equal(trecs.promoted.numpy(), promoted)
    np.testing.assert_array_equal(trecs.ref_has.numpy(), np.asarray(jrecs.ref_has))
    np.testing.assert_array_equal(trecs.ref_tri.numpy(), np.asarray(jrecs.ref_tri))
    np.testing.assert_allclose(trecs.ref_pos.numpy(), np.asarray(jrecs.ref_pos), rtol=1e-5, atol=1e-5)
    assert int(tfsr) == int(jfsr)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-6)
    np.testing.assert_array_equal(ts.ref_has_landmark.numpy(), np.asarray(js.ref_has_landmark))
    np.testing.assert_allclose(ts.ref_landmarks.numpy(), np.asarray(js.ref_landmarks), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- host promotion mint
def test_create_stereo_points_matches_jax():
    """Both packages' ``_create_stereo_points`` on one keyframe (pose off
    the origin, 48 keypoints, two slots already holding a landmark) and
    one step output (a depth-invalid slot, depths at and beyond the depth
    window, an invalid keypoint with a depth)."""
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.map import Frame as JFrame
    from visual_slam_tpu.map import KeyFrame as JKeyFrame
    from visual_slam_tpu.map import MapPoint as JMapPoint
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu.ops.detector import Features as JFeatures
    from visual_slam_tpu_torch.map import Frame, KeyFrame, MapPoint
    from visual_slam_tpu_torch.ops.detector import Features

    rng = np.random.default_rng(7)
    nk = 48
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    xy = rng.uniform([5, 5], [315, 235], (nk, 2)).astype(np.float32)
    desc = rng.integers(0, 2**32, (nk, 8), dtype=np.uint64).astype(np.uint32)
    valid = np.arange(nk) != 3
    z = rng.uniform(1.0, 30.0, nk).astype(np.float32)
    z[5], z[6], z[7] = 0.05, 50.0, 80.0  # below, at and beyond the depth window (0.1, 50)
    z_ok = rng.random(nk) > 0.2
    z_ok[[3, 5, 6, 7, 8, 9]] = True
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.eye(4)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = [0.4, -0.2, 1.5]
    cols = dict(response=np.ones(nk, np.float32), angle=np.zeros(nk, np.float32), octave=np.zeros(nk, np.int32),
                size=np.full(nk, 31.0, np.float32))

    def make(pkg):
        if pkg == "jax":
            cfg = JConfig()
            cfg.camera.sensor_type = "stereo"
            slam = JCompiledSLAM(JCamera(width=320, height=240, K=K, baseline=0.5), cfg)
            feats = JFeatures(xy=xy, desc=desc, valid=valid, **cols)
            fr, kf_cls, mp_cls = JFrame(features=[feats], timestamp=0.3), JKeyFrame, JMapPoint
        else:
            cfg = Config()
            cfg.camera.sensor_type = "stereo"
            slam = CompiledSLAM(PinholeCamera(width=320, height=240, K=K, baseline=0.5), cfg, device="cpu")
            feats = Features(xy=torch.from_numpy(xy), desc=torch.from_numpy(desc.view(np.int32)),
                             valid=torch.from_numpy(valid), **{k: torch.from_numpy(v) for k, v in cols.items()})
            fr, kf_cls, mp_cls = Frame(features=[feats], timestamp=0.3), KeyFrame, MapPoint
        fr.update_pose(T)
        kf = kf_cls.from_frame(fr)
        for i in (8, 11):  # slots that hold a landmark already: no mint there
            kf.add_map_point(0, i, mp_cls(np.array([0.0, 0.0, 10.0])))
        return slam, kf

    (js, jkf), (ts, tkf) = make("jax"), make("torch")
    out = types.SimpleNamespace(kp_z=z, kp_z_valid=z_ok)  # all either package reads of the step output
    n_j, n_t = js._create_stereo_points(jkf, out), ts._create_stereo_points(tkf, out)
    assert n_t == n_j > 20
    np.testing.assert_array_equal(tkf.kp_z_valid, jkf.kp_z_valid)
    np.testing.assert_array_equal(tkf.kp_z, jkf.kp_z)
    assert not tkf.kp_z_valid[[3, 5, 6, 7]].any() and tkf.kp_z_valid[9]
    slots = sorted(k for _, k in jkf.map_points)
    assert sorted(k for _, k in tkf.map_points) == slots
    for k in slots:
        np.testing.assert_allclose(tkf.get_map_point(0, k).position, jkf.get_map_point(0, k).position,
                                   rtol=1e-9, atol=1e-9)
        if k not in (8, 11):
            np.testing.assert_array_equal(np.asarray(tkf.get_map_point(0, k).descriptor).view(np.uint32),
                                          np.asarray(jkf.get_map_point(0, k).descriptor))
    assert ts.map.num_map_points() == js.map.num_map_points() == n_j


# ------------------------------------------------------------------ whole runs
def test_single_frame_route(runs):
    """JAX ``test_compiled_slam_stereo``'s world and gates: every pair a step,
    keyframes from ``_decide`` -> ``_promote_keyframe`` with disparity
    landmarks (``_create_stereo_points``) on each heavy promotion."""
    slam, infos, probe, ate = runs["single"]
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert ate < BOUNDS["single"], ate
    assert slam.map.num_map_points() > 50
    kfs = slam.map.get_keyframes()
    assert len(kfs) >= 3 and all(kf.kp_z_valid is not None and kf.kp_z_valid.any() for kf in kfs[1:])
    assert probe.minted == []  # no device promotion on this route


def test_device_promotion_route(runs):
    """JAX ``test_compiled_slam_stereo_device_promotion``'s world and gates:
    chunks of 7 that promote on the device and mint from the step's depths;
    the host adopts the minted slots (``ref_tri``) as landmarks."""
    slam, infos, probe, ate = runs["promotion"]
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3
    ts, _ = slam.trajectory()
    assert slam.num_frames_tracked() == len(ts) >= 14
    assert ate < BOUNDS["promotion"], ate
    assert probe.minted and min(probe.minted) > 0, probe.minted
    assert probe.double_mints == 0  # the device route mints once


def test_plain_chunk_route_same_bound_as_jax(runs):
    """The device-promotion world in plain chunks of 4: the host promotes
    the newest healthy frame at each boundary, with disparity landmarks.
    Both packages are held to the device-promotion test's bound."""
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse as jate

    js, _, jprobe, _ = _run("plain", slam_cls=JCompiledSLAM, camera_cls=JCamera, config_cls=JConfig)
    lefts, rights, K, Ts = spw.small_frames("plain")
    ate_j = spw.metric_ate(jate, *js.trajectory(), Ts)[0]
    slam, infos, probe, ate = runs["plain"]
    msg = f"port ATE {ate:.4f} m, JAX {ate_j:.4f} m; double mints port {probe.double_mints}, JAX {jprobe.double_mints}"
    assert js.state.name == "OK" and ate_j < BOUNDS["plain"], msg
    assert slam.state == State.OK, (msg, [i["state"] for i in infos])
    assert ate < BOUNDS["plain"], msg
    assert slam.num_frames_tracked() == js.num_frames_tracked() == len(lefts)


def test_blank_pair_goes_lost_then_relocalizes(runs):
    """Single-frame route, pair BLANK blanked out in both cameras: it
    tracks nothing, its deferred decision (on the next call) finds nothing
    to brute-match, so the system goes LOST; the call after relocalizes
    against a recent keyframe with the stereo step, which promotes that
    pair with disparity landmarks, and tracking goes on to the end."""
    slam, infos, _, ate = runs["reloc"]
    states = [i.get("state") for i in infos]
    assert states[BLANK + 1] == "LOST", states
    assert infos[BLANK + 2].get("relocalized") is True, infos[BLANK + 2]
    assert infos[BLANK + 2]["n_inliers"] >= slam.config.tracking.min_inliers
    assert all(s == "OK" for s in states[BLANK + 2:]), states
    assert slam.state == State.OK
    kf = next(kf for kf in slam.map.get_keyframes() if abs(kf.timestamp - (BLANK + 2) * spw.DT) < 1e-9)
    assert kf.kp_z_valid is not None and kf.kp_z_valid.any()
    assert ate < BOUNDS["single"], ate


def test_bootstrap_landmarks_fill_the_arena():
    """The port's departure from the JAX package (ROADMAP F6): the one-pair
    bootstrap's landmarks take the descriptors of the keypoints they were
    made from, as the two-view bootstrap's do, so the landmark arena holds
    them from the first chunk on (the JAX package leaves them without one
    and its arena empty until the first adopted keyframe)."""
    lefts, rights, K, _ = spw.small_frames("promotion")
    slam = CompiledSLAM(spw.camera(PinholeCamera, lefts, K, spw.SMALL_BASELINE), spw.small_config(Config, "promotion"),
                        device="cpu")
    with _threads(1):
        slam.track([lefts[0], rights[0]], timestamp=0.0)
    assert slam.state == State.OK
    kf = slam.map.get_last_keyframe()
    desc = kf.descriptors(0)
    assert kf.num_map_points() >= 30
    for (cam, i), mp in kf.map_points.items():
        np.testing.assert_array_equal(mp.descriptor, desc[i])
    assert int(slam._track_state.lm_valid.sum()) == kf.num_map_points()


# --------------------------------------------------------------- image inputs
def _system(**changes):
    cfg = spw.small_config(Config, "promotion")
    cfg.tracking.upload_f16 = True
    for key, v in changes.items():
        setattr(cfg.tracking, key, v)
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    return CompiledSLAM(PinholeCamera(width=320, height=240, K=K, baseline=0.5), cfg, device="cpu")


def test_pair_inputs():
    """A pair of f32 images: ``_img_buf`` gives an f16 (2, H, W) host entry,
    ``_stack_imgs`` a contiguous (C, 2, H, W) tensor, ``_img_arg`` a (2, H,
    W) tensor of the images' own dtype."""
    slam = _system()
    rng = np.random.default_rng(0)
    left, right = (rng.uniform(0, 255, (240, 320)).astype(np.float32) for _ in range(2))
    buf = slam._img_buf([left, right])
    assert isinstance(buf, np.ndarray) and buf.dtype == np.float16 and buf.shape == (2, 240, 320)
    np.testing.assert_array_equal(buf[1], right.astype(np.float16))
    stacked = slam._stack_imgs([buf, buf, buf])
    assert stacked.shape == (3, 2, 240, 320) and stacked.is_contiguous() and stacked.dtype == torch.float16
    arg = slam._img_arg([left, right])
    assert arg.shape == (2, 240, 320) and arg.dtype == torch.float32
    assert torch.equal(arg[0], torch.from_numpy(left))
    tbuf = slam._img_buf([torch.from_numpy(left), torch.from_numpy(right)])
    assert tbuf.shape == (2, 240, 320) and torch.equal(tbuf[1], torch.from_numpy(right))


@pytest.mark.parametrize("call", ["_img_buf", "_img_arg", "track"])
def test_one_image_raises(call):
    """A stereo system given one image raises JAX's ``ValueError`` on each
    path that takes images (``track`` once the system is OK)."""
    slam = _system()
    img = np.zeros((240, 320), np.float32)
    with pytest.raises(ValueError, match=r"needs \[left, right\] images"):
        if call == "track":
            slam.state = State.OK
            slam.track([img], timestamp=0.0)
        else:
            getattr(slam, call)([img])


# ----------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_device_promotion_on_the_card_against_its_cpu_run():
    """The device-promotion world on the card: the JAX test's gates, the
    keyframe count within 2 of its CPU run's and the ATE within 0.1 m of
    it, and K1 launched once a pair: one batched launch per step and per
    bootstrap pair, the one-frame K1 never; K3 once a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels

    with _threads(1):
        cpu, _, _, ate_cpu = _run("promotion")
    counters = (patches_and_moments_batched, patches_and_moments_levels, mk.guided_top2)
    before = [c.launches for c in counters]
    steps = []
    forward0 = tpl.TrackStep.forward

    def forward(self, state, img):
        steps.append(img.shape)
        return forward0(self, state, img)

    tpl.TrackStep.forward = forward
    try:
        slam, infos, probe, ate = _run("promotion", device="cuda")
    finally:
        tpl.TrackStep.forward = forward0
    launches = [c.launches - n for c, n in zip(counters, before)]
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3 and slam.num_frames_tracked() >= 14
    assert ate < BOUNDS["promotion"] and abs(ate - ate_cpu) < 0.1, (ate, ate_cpu)
    assert abs(slam.map.num_keyframes() - cpu.map.num_keyframes()) <= 2
    assert probe.minted and min(probe.minted) > 0
    assert all(s == (2, 240, 320) for s in steps)
    assert launches == [len(steps) + 1, 0, len(steps)], (launches, len(steps))
