"""The port's RGB-D ``CompiledSLAM`` (``camera.sensor_type = "rgbd"``)
against the JAX package's, on the CPU.

Neither package has an RGB-D step: the system bootstraps from one frame's
depth map, then runs the mono step, the mono chunks and mono promotion with
triangulation; relocalization ignores depth.

- Whole runs of tests/rgbd_pipeline_world.py's small world (320x240, 16
  frames, tests/test_stereo_rgbd.py's settings; metric ATE, no scale
  alignment) through each route, frame by frame, plain chunks of 4 and
  self-promoting chunks of 4, each from the port's own bootstrap at one
  torch thread (ROADMAP Q3.4), beside the JAX package's run of the same
  route: no LOST frame, a pose for every frame, keyframes within 2 of JAX's,
  the ATE within ``BOUNDS``. The bounds come from the JAX package's runs of
  the world (scripts/rgbd_pipeline_reference.py --impl jax --world small,
  at eps 0, +-1e-6, 2e-6 and 3e-6 and RANSAC seeds 0-3): frame by frame
  0.067-0.149 m, self-promoting 0.062-0.152 m, plain chunks 0.169-0.564 m
  (the host promotes the newest healthy frame of a chunk, and the world is
  chaotic to rounding there).
- The bootstrap on frame 0 against JAX's on the same frame: the landmark
  count, and the landmarks of keypoints both packages detect at the same
  pixel at the same place (float64 back-projection in both).
- A frame without a depth map leaves both packages ``INITIALIZING``; the
  next one with depth bootstraps.
- A blank frame goes LOST and the next one relocalizes (single frame).
- ``save`` / ``resume`` of an RGB-D system saved by either package: an
  RGB-D system is rebuilt with the mono step and tracks to the end.

The ``cuda`` case runs the self-promoting route on the card against its
own CPU run and skips here; JAX is imported only inside the fixtures and
tests that compare with it, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_rgbd_compiled_slam.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

import rgbd_pipeline_world as rpw
from visual_slam_tpu_torch import pipeline as tpl
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse

BOUNDS = {"single": 0.25, "plain": 0.6, "promotion": 0.25}  # metric ATE (m), above JAX's runs of each route
KF_SLACK = 2  # keyframes within this many of JAX's run of the route
BLANK = 5  # the frame blanked out in the relocalization run
SAVE_AFTER = 8  # frames tracked before the checkpoint


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _jax_classes():
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse as jate

    return JCompiledSLAM, JCamera, JConfig, jate


def _system(route: str, device="cpu", jax=False):
    imgs, _, K, _ = rpw.small_frames()
    if jax:
        slam_cls, camera_cls, config_cls, _ = _jax_classes()
        return slam_cls(rpw.camera(camera_cls, imgs, K), rpw.small_config(config_cls, route))
    return CompiledSLAM(rpw.camera(PinholeCamera, imgs, K), rpw.small_config(Config, route), device=device)


def _run(route: str, device="cpu", blank=None, jax=False):
    """The small world through one route of either package's RGB-D
    ``CompiledSLAM``, from frame 0's bootstrap, then ``shutdown()``.
    Returns (slam, infos, probe, metric ATE m)."""
    imgs, depths, _, Ts = rpw.small_frames()
    slam = _system(route, device, jax)
    assert not slam._stereo
    probe = rpw.Probe(slam)
    infos = []
    for i, (img, depth) in enumerate(zip(imgs, depths)):
        if i == blank:
            img, depth = np.zeros_like(img), np.zeros_like(depth)
        infos.append(slam.track([img], timestamp=i * rpw.DT, depth=depth))
    slam.shutdown()
    ate = _jax_classes()[3] if jax else ate_rmse
    return slam, infos, probe, rpw.metric_ate(ate, *slam.trajectory(), Ts)[0]


@pytest.fixture(scope="module")
def runs():
    with _threads(1):
        out = {r: _run(r) for r in rpw.ROUTES}
        out["reloc"] = _run("single", blank=BLANK)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {r: _run(r, jax=True) for r in rpw.ROUTES}


# ------------------------------------------------------------------ whole runs
@pytest.mark.parametrize("route", list(rpw.ROUTES))
def test_route_against_jax(runs, jax_runs, route):
    """Each route: both packages bootstrap on frame 0 and pose every frame
    without a LOST one; the port's keyframes within KF_SLACK of JAX's and
    its metric ATE within the route's bound."""
    slam, infos, probe, ate = runs[route]
    js, jinfos, jprobe, ate_j = jax_runs[route]
    msg = (f"{route}: port ATE {ate:.4f} m, JAX {ate_j:.4f} m (bound {BOUNDS[route]}); keyframes port "
           f"{slam.map.num_keyframes()}, JAX {js.map.num_keyframes()}")
    assert [i["state"] for i in jinfos] == ["OK"] * len(jinfos), (msg, jinfos)
    assert [i["state"] for i in infos] == ["OK"] * len(infos), (msg, infos)
    assert slam.state == State.OK and js.state.name == "OK", msg
    assert slam.num_frames_tracked() == js.num_frames_tracked() == rpw.SMALL_FRAMES, msg
    assert abs(slam.map.num_keyframes() - js.map.num_keyframes()) <= KF_SLACK, msg
    assert ate < BOUNDS[route], msg
    # Promotion happens where JAX's does: inside the chunk on the device route only.
    assert bool(probe.minted) == bool(jprobe.minted) == (route == "promotion"), (probe.minted, jprobe.minted)
    assert probe.ba_solves >= 1 and jprobe.ba_solves >= 1


def test_bootstrap_matches_jax():
    """Frame 0 through both packages' RGB-D bootstrap: as many landmarks
    within 1 %, each from a valid keypoint with a depth in the
    initializer's range, and at every keypoint both packages detect at the
    same pixel, the same landmark position (to 1e-9 m) with no descriptor
    (the one-frame bootstrap gives none, in both packages, so the landmark
    arena starts empty)."""
    imgs, depths, _, _ = rpw.small_frames(1)
    port, jax = _system("promotion"), _system("promotion", jax=True)
    with _threads(1):
        port.track([imgs[0]], timestamp=0.0, depth=depths[0])
    jax.track([imgs[0]], timestamp=0.0, depth=depths[0])
    assert port.state == State.OK and jax.state.name == "OK"
    (kf,), (jkf,) = port.map.get_keyframes(), jax.map.get_keyframes()
    n, n_j = kf.num_map_points(), jkf.num_map_points()
    assert n >= port.config.initialization.min_inliers and abs(n - n_j) <= 0.01 * n_j, (n, n_j)
    icfg = port.config.initialization

    def by_pixel(k):
        xy = k.keypoints(0)
        return {tuple(np.round(xy[i], 3)): mp for (cam, i), mp in k.map_points.items()}

    ours, theirs = by_pixel(kf), by_pixel(jkf)
    shared = set(ours) & set(theirs)
    assert len(shared) >= 0.95 * n_j, (len(shared), n_j)
    for px in shared:
        np.testing.assert_allclose(ours[px].position, theirs[px].position, rtol=0, atol=1e-9)
        assert ours[px].descriptor is None and theirs[px].descriptor is None
        z = depths[0][int(round(px[1])), int(round(px[0]))]
        assert icfg.min_depth < z < icfg.max_depth
    assert not bool(port._track_state.lm_valid.any())


def test_frame_without_depth_stays_initializing():
    """Frame 0 without a depth map leaves both packages INITIALIZING (no
    map); frame 1 with its depth map bootstraps both."""
    imgs, depths, _, _ = rpw.small_frames(2)
    port, jax = _system("single"), _system("single", jax=True)
    with _threads(1):
        info = port.track([imgs[0]], timestamp=0.0)
    jinfo = jax.track([imgs[0]], timestamp=0.0)
    assert info["state"] == jinfo["state"] == "INITIALIZING"
    assert port.map.num_keyframes() == jax.map.num_keyframes() == 0
    assert port.num_frames_tracked() == jax.num_frames_tracked() == 0
    with _threads(1):
        info = port.track([imgs[1]], timestamp=rpw.DT, depth=depths[1])
    jinfo = jax.track([imgs[1]], timestamp=rpw.DT, depth=depths[1])
    assert info["state"] == jinfo["state"] == "OK"
    assert port.map.get_last_keyframe().timestamp == jax.map.get_last_keyframe().timestamp == rpw.DT


def test_blank_frame_goes_lost_then_relocalizes(runs):
    """Frame by frame, frame BLANK blanked out (image and depth): it tracks
    nothing, its deferred decision (on the next call) finds nothing to
    brute-match, so the system goes LOST; the call after relocalizes
    against a recent keyframe with the mono step and no depth, and tracking
    goes on to the end."""
    slam, infos, _, ate = runs["reloc"]
    states = [i.get("state") for i in infos]
    assert states[BLANK + 1] == "LOST", states
    assert infos[BLANK + 2].get("relocalized") is True, infos[BLANK + 2]
    assert infos[BLANK + 2]["n_inliers"] >= slam.config.tracking.min_inliers
    assert all(s == "OK" for s in states[BLANK + 2:]), states
    assert slam.state == State.OK
    assert any(abs(kf.timestamp - (BLANK + 2) * rpw.DT) < 1e-9 for kf in slam.map.get_keyframes())
    assert ate < BOUNDS["single"], ate


@pytest.mark.parametrize("saved_by", ["torch", "jax"])
def test_save_and_resume(tmp_path, saved_by):
    """Frame by frame, SAVE_AFTER frames, ``flush()`` and ``save``, by either
    package; the port's ``resume`` rebuilds an RGB-D system with the mono
    step, the saved keyframes, landmarks and poses, and tracks the rest of
    the world without a LOST frame within the route's bound."""
    imgs, depths, K, Ts = rpw.small_frames()
    saved = _system("single", jax=saved_by == "jax")
    with _threads(1):
        for i in range(SAVE_AFTER):
            saved.track([imgs[i]], timestamp=i * rpw.DT, depth=depths[i])
        saved.flush()
    saved.save(tmp_path / "ckpt")
    with _threads(1):
        slam = CompiledSLAM.resume(tmp_path / "ckpt", rpw.camera(PinholeCamera, imgs, K), device="cpu")
        assert slam.config.camera.sensor_type == "rgbd" and not slam._stereo and not slam._step.stereo
        assert slam.state == State.OK
        assert slam.map.num_keyframes() == saved.map.num_keyframes()
        assert slam.map.num_map_points() == saved.map.num_map_points()
        assert slam.num_frames_tracked() == SAVE_AFTER
        infos = [slam.track([imgs[i]], timestamp=i * rpw.DT, depth=depths[i]) for i in range(SAVE_AFTER, len(imgs))]
        slam.shutdown()
    assert all(i["state"] == "OK" for i in infos), infos
    ts, T = slam.trajectory()
    assert len(ts) == len(imgs)
    assert rpw.metric_ate(ate_rmse, ts, T, Ts)[0] < BOUNDS["single"]


# ----------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_device_promotion_on_the_card_against_its_cpu_run():
    """The self-promoting route on the card: no LOST frame, the keyframe
    count within 2 of its CPU run's and the ATE within the route's bound
    and 0.1 m of the CPU run's; K1 (the one-frame wrapper) once a frame:
    the bootstrap detect and one a step; the batched K1 never; K3 once a
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops import match_kernels as mk
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels

    with _threads(1):
        cpu, _, _, ate_cpu = _run("promotion")
    counters = (patches_and_moments_levels, patches_and_moments_batched, mk.guided_top2)
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
    assert [i["state"] for i in infos] == ["OK"] * len(infos), infos
    assert slam.state == State.OK and slam.num_frames_tracked() == rpw.SMALL_FRAMES
    assert ate < BOUNDS["promotion"] and abs(ate - ate_cpu) < 0.1, (ate, ate_cpu)
    assert abs(slam.map.num_keyframes() - cpu.map.num_keyframes()) <= 2
    assert probe.minted and probe.ba_solves >= 1
    assert all(s == (240, 320) for s in steps)
    assert launches == [len(steps) + 1, 0, len(steps)], (launches, len(steps))
