"""Helpers of the stereo and RGB-D facade parity tests
(tests/test_torch_depth_facade.py, tests/test_torch_stereo.py): the JAX
facade and the port's on tests/test_stereo_rgbd.py's worlds
(tests/depth_world.py), the port continued from the JAX facade's state,
landmark comparisons and whole runs of both packages."""
from __future__ import annotations

import numpy as np

import depth_world as dw
from visual_slam_tpu.camera import PinholeCamera as JCamera
from visual_slam_tpu.config import Config as JConfig
from visual_slam_tpu.slam import SLAM as JSLAM
from visual_slam_tpu.utils.metrics import ate_rmse as jate
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.slam import SLAM
from visual_slam_tpu_torch.utils.metrics import ate_rmse

def world(sensor):
    if sensor == "stereo":
        a, b, K, Ts = dw.e2e_stereo_frames(10)
    else:
        a, b, K, Ts = dw.e2e_rgbd_frames(8)
    return (a, b), K, Ts


def slams(sensor, fused=False, n_track=0):
    """(JAX SLAM after ``n_track`` frames, the port's SLAM on the CPU, the
    world) with the same settings."""
    seq, K, Ts = world(sensor)
    baseline = dw.E2E_BASELINE if sensor == "stereo" else 0.0
    js = JSLAM(JCamera(width=320, height=240, K=K, baseline=baseline), dw.e2e_config(JConfig, sensor, fused))
    for i in range(n_track):
        images, depth = dw.track_args(sensor, seq, i)
        js.track(images, timestamp=i * dw.DT, depth=depth)
    ts = SLAM(PinholeCamera(width=320, height=240, K=K, baseline=baseline), dw.e2e_config(Config, sensor, fused),
              device="cpu")
    return js, ts, seq, Ts


def install(js, ts):
    jt = js.tracking
    interop.install_slam_state(ts, js.map.get_keyframes(), js.map.get_map_points(), jt.reference_keyframe.keyframe_id,
                               jt.last_frame.T_w2c, jt.motion_model, jt.last_keyframe_frame_id, jt.last_frame.id,
                               gauge_log=js.map._gauge_log)


def same_landmarks(jkf, tkf, rtol):
    jslots, tslots = sorted(jkf.map_points), sorted(tkf.map_points)
    assert tslots == jslots and len(jslots) >= 30
    jp = np.stack([jkf.map_points[k].position for k in jslots])
    tp = np.stack([tkf.map_points[k].position for k in tslots])
    np.testing.assert_allclose(tp, jp, rtol=rtol, atol=0)


def run_both(sensor, fused):
    """Both packages over the whole world: {impl: (state, keyframe timestamps,
    ATE without alignment, ATE with a fitted scale)}."""
    js, ts, seq, Ts = slams(sensor, fused)
    out = {}
    for name, slam, ate in (("jax", js, jate), ("torch", ts, ate_rmse)):
        for i in range(len(seq[0])):
            images, depth = dw.track_args(sensor, seq, i)
            slam.track(images, timestamp=i * dw.DT, depth=depth)
        kfs = slam.map.get_keyframes()
        idx = [int(round(kf.timestamp / dw.DT)) for kf in kfs]
        est = np.stack([kf.t_c2w for kf in kfs])
        gt = np.stack([-Ts[i][:3, :3].T @ Ts[i][:3, 3] for i in idx])
        out[name] = (slam.state.name, [kf.timestamp for kf in kfs], ate(est, gt, align_scale=False),
                     ate(est, gt, align_scale=True))
    return out
