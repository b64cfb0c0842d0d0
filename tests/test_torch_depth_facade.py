"""The port's stereo and RGB-D host facade against the JAX package's, on the
CPU, on tests/test_stereo_rgbd.py's worlds (320x240, f = 260; stereo:
world seed 5, 10 frames, baseline 0.5 m; RGB-D: world seed 9, 8 frames)
with that test's settings (tests/depth_world.py).

- One-frame bootstraps: the port's initializer on the JAX bootstrap frame's
  own features (``interop.frame_from_numpy``), the left/right match fed the
  JAX fundamental filter's draws: the same landmark count and keypoint
  slots, positions within 1e-4 relative.
- One fused frame (``make_frame_step(stereo=True)`` / ``(rgbd=True)``): the
  port's facade continues from the JAX facade's state
  (``interop.install_slam_state``), builds its own landmark block and
  predicted pose, and its step sees the JAX step's features and RANSAC
  draws: the same depths and depth validity, the same guided associations
  and inliers exactly, the pose within 1e-4.
- Keyframe handlers: the stereo and RGB-D handlers on a copy of the same
  JAX keyframe mint landmarks at the same slots, positions within 1e-5
  relative, from the frame's depths and, without them, from their own
  measurement.
- End to end: tests/test_stereo_rgbd.py's first non-slow case (the stereo
  world: bootstrap on frame 0, state OK, metric keyframe ATE below 0.3 m
  without scale alignment, a fitted scale within 0.8-1.25) through the
  port's ``SLAM``, beside the JAX package's run of the same world, which
  must pass the same bands; its other three (RGB-D, and both sensors fused)
  are in tests/test_torch_stereo.py, which has room for them.
- ``StereoVO`` and ``RGBDVO`` set their sensor and bootstrap on frame 0 as
  the JAX package's do; ``StereoVO`` refuses a camera without a baseline.
- ``CompiledSLAM`` builds the stereo step for stereo and, as the JAX
  package does, the mono step for RGB-D; a stereo frame without its right
  image and an RGB-D frame without depth raise in the facade.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depth_world as dw
import facade_parity as fp
from depth_parity import install, run_both, same_landmarks, slams, world
from visual_slam_tpu.map import KeyFrame as JKeyFrame
from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config

ATE_MAX_M = 0.3  # tests/test_stereo_rgbd.py's band


@pytest.fixture(scope="module", autouse=True)
def threads():
    torch.set_num_threads(2)


# -- one-frame bootstraps ----------------------------------------------------


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_bootstrapsame_landmarks(sensor):
    js, ts, seq, _ = slams(sensor)
    images, depth = dw.track_args(sensor, seq, 0)
    with fp.shared_match_draws(js.tracking.tracker, ts.tracking.tracker) as queue:
        js.track(images, timestamp=0.0, depth=depth)
        assert js.state.name == "OK"
        tf = interop.frame_from_numpy(js.map.get_frames()[0], "cpu")
        ts.map.add_frame(tf)
        init = ts.tracking.initializer
        assert (init._initialize_stereo if sensor == "stereo" else init._initialize_rgbd)(tf)
        assert not queue  # the port made every match the JAX package made
    jkf, tkf = js.map.get_keyframes(), ts.map.get_keyframes()
    assert len(jkf) == len(tkf) == 1 and tkf[0].id == jkf[0].id
    same_landmarks(jkf[0], tkf[0], rtol=1e-4)
    assert ts.map.num_map_points() == js.map.num_map_points()


# -- one fused frame from the JAX facade's state -------------------------------


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_fused_frame_step_matches_jax(sensor):
    n = 4
    js, ts, seq, _ = slams(sensor, fused=True, n_track=n)
    assert js.state.name == "OK"
    install(js, ts)
    jt, tt = js.tracking, ts.tracking
    jalg, talg = jt.algorithm, tt.algorithm
    jstep, tstep = jalg._get_step(jt), talg._get_step(tt)
    images, depth = dw.track_args(sensor, seq, n)
    img = np.stack([images[0], images[1]] if sensor == "stereo" else [images[0], depth]).astype(np.float32)

    jpos, jdesc, jvalid, _ = jt._local_landmark_block(jalg.n_local_keyframes)
    tpos, tdesc, tvalid, _ = tt._local_landmark_block(talg.n_local_keyframes)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tdesc, jdesc.view(np.int32))
    np.testing.assert_array_equal(tvalid, jvalid)
    jT_pred = jt.motion_model @ jt.last_frame.T_w2c
    tT_pred = tt.motion_model @ tt.last_frame.T_w2c
    np.testing.assert_allclose(tT_pred, jT_pred, rtol=0, atol=1e-12)

    key = jax.random.PRNGKey(5)
    jo = jstep(jnp.asarray(img), jnp.asarray(jpos), jnp.asarray(jdesc), jnp.asarray(jvalid),
               jnp.asarray(jT_pred, jnp.float32), key)
    # The port's step sees the JAX step's features (K1 and BRIEF are held
    # elsewhere) and the JAX sampler's minimal sets.
    jfeats = [jo["features"]] + ([jo["features_right"]] if sensor == "stereo" else [])
    tfeats = [interop.features_from_numpy(f, "cpu") for f in jfeats]
    batch = type(tfeats[0])(*[torch.stack(x) for x in zip(*tfeats)]) if sensor == "stereo" else tfeats[0]
    tstep.step.detect = lambda _img: batch
    pv = np.asarray(jo["pair_valid"])
    idx = torch.from_numpy(np.array(jepi._sample_minimal_sets(key, jnp.asarray(pv), tstep.step.pnp_hypotheses, 6)))
    to = tstep(torch.from_numpy(img), tt._t(tpos), torch.from_numpy(tdesc), tt._t(tvalid, torch.bool),
               tt._t(tT_pred), talg._gen, sample_idx=idx)

    np.testing.assert_array_equal(to["kp_z_valid"].numpy(), np.asarray(jo["kp_z_valid"]))
    ok = np.asarray(jo["kp_z_valid"])
    assert ok.sum() >= 30
    np.testing.assert_allclose(to["kp_z"].numpy()[ok], np.asarray(jo["kp_z"])[ok], rtol=1e-6)
    np.testing.assert_array_equal(to["pair_valid"].numpy(), pv)
    np.testing.assert_array_equal(to["lm_idx"].numpy()[pv], np.asarray(jo["lm_idx"])[pv])
    np.testing.assert_array_equal(to["pnp_inliers"].numpy(), np.asarray(jo["pnp_inliers"]))
    assert int(to["n_inliers"]) == int(jo["n_inliers"]) >= 30
    np.testing.assert_allclose(to["T_w2c"].numpy(), np.asarray(jo["T_w2c"]), atol=1e-4)


# -- keyframe handlers -------------------------------------------------------------


@pytest.mark.parametrize("sensor,measured", [("stereo", True), ("stereo", False), ("rgbd", True), ("rgbd", False)])
def test_handler_mintssame_landmarks(sensor, measured):
    """``measured``: the keyframe carries its tracking-time depths; else the
    handler measures them itself."""
    js, ts, seq, _ = slams(sensor, n_track=3)
    install(js, ts)
    jf = js.map.get_last_frame()
    assert jf.kp_z is not None
    jkf = JKeyFrame.from_frame(jf)
    tkf = interop.keyframe_from_numpy(jf.features, jf.T_w2c, jkf.keyframe_id + 1000, frame_id=jf.id, device="cpu",
                                      depths=jf)
    tkf.images, tkf.images_gray = list(jf.images), list(jf.images_gray)
    np.testing.assert_array_equal(tkf.kp_z_valid, jf.kp_z_valid)
    if not measured:
        jkf.kp_z = jkf.kp_z_valid = tkf.kp_z = tkf.kp_z_valid = None
    jh, th = js.local_mapping.handler, ts.local_mapping.handler
    if sensor == "stereo":
        jn, tn = jh._create_stereo_points(jkf), th._create_stereo_points(tkf)
    else:
        jn, tn = jh._create_depth_points(jkf), th._create_depth_points(tkf)
    assert tn == jn
    same_landmarks(jkf, tkf, rtol=1e-5)
    for key, mp in tkf.map_points.items():
        np.testing.assert_array_equal(mp.descriptor, np.asarray(jkf.map_points[key].descriptor).view(np.int32))


# -- end to end: tests/test_stereo_rgbd.py's cases, both packages -------------


@pytest.fixture(scope="module")
def stereo_run():
    return run_both("stereo", False)


@pytest.mark.parametrize("impl", ["torch", "jax"])
def test_stereo_initializes_first_frame(stereo_run, impl):
    state, stamps, _, _ = stereo_run[impl]
    assert state == "OK" and len(stamps) >= 2 and stamps[0] == 0.0


@pytest.mark.parametrize("impl", ["torch", "jax"])
def test_stereo_metric_scale(stereo_run, impl):
    _, _, metric, fitted = stereo_run[impl]
    assert abs(metric["scale"] - 1.0) < 1e-9  # no scale was fitted
    assert metric["rmse"] < ATE_MAX_M, {k: v["rmse"] for k, (_, _, v, _) in stereo_run.items()}
    assert 0.8 < fitted["scale"] < 1.25


# -- what still raises -------------------------------------------------------------


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_unported_depth_paths_raise(sensor):
    """Both depth sensors are ported to ``CompiledSLAM``: stereo builds a
    system around the stereo step; RGB-D, as in the JAX package
    (compiled_slam.py:80-84), around the mono step, even with a camera
    baseline."""
    from visual_slam_tpu_torch import models

    cam = PinholeCamera(width=320, height=240, K=dw.E2E_K, baseline=0.5)
    cfg = Config()
    cfg.camera.sensor_type = sensor
    slam = models.CompiledSLAM(cam, cfg, device="cpu")
    if sensor == "stereo":
        assert slam._stereo and slam._step.stereo and slam._step.baseline == 0.5
    else:
        assert not slam._stereo and not slam._step.stereo


@pytest.mark.parametrize("family", ["StereoVO", "RGBDVO"])
def test_depth_families_bootstrap_as_jax(family):
    from visual_slam_tpu import models as jmodels
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu_torch import models

    sensor = "stereo" if family == "StereoVO" else "rgbd"
    (seq, K, _), baseline = world(sensor), dw.E2E_BASELINE if sensor == "stereo" else 0.0
    js = getattr(jmodels, family)(JCamera(width=320, height=240, K=K, baseline=baseline),
                                  config=dw.e2e_config(JConfig, "monocular"))
    ts = getattr(models, family)(PinholeCamera(width=320, height=240, K=K, baseline=baseline),
                                 config=dw.e2e_config(Config, "monocular"), device="cpu")
    images, depth = dw.track_args(sensor, seq, 0)
    for slam in (js, ts):
        assert slam.config.camera.sensor_type == sensor
        slam.track(images, timestamp=0.0, depth=depth)
        assert slam.state.name == "OK" and len(slam.map.get_keyframes()) == 1  # the one-frame bootstrap


@pytest.mark.parametrize("impl", ["torch", "jax"])
def test_stereo_family_needs_a_baseline(impl):
    if impl == "jax":
        from visual_slam_tpu.camera import PinholeCamera as Camera
        from visual_slam_tpu.models import StereoVO
        kwargs = {}
    else:
        from visual_slam_tpu_torch.models import StereoVO
        Camera, kwargs = PinholeCamera, {"device": "cpu"}
    with pytest.raises(ValueError, match="baseline"):
        StereoVO(Camera(width=320, height=240, K=dw.E2E_K), **kwargs)


@pytest.mark.parametrize("sensor,fused", [("stereo", False), ("stereo", True), ("rgbd", False), ("rgbd", True)])
def test_missing_second_modality_raises(sensor, fused):
    _, ts, seq, _ = slams(sensor, fused)
    images, depth = dw.track_args(sensor, seq, 0)
    ts.track(images, timestamp=0.0, depth=depth)
    assert ts.state.name == "OK"
    with pytest.raises(ValueError, match="right" if sensor == "stereo" else "depth"):
        ts.track(images[:1], timestamp=0.1, depth=None)
