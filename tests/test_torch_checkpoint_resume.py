"""Checkpoint and resume in the port, held to the JAX package's
``tests/test_checkpoint_resume.py`` on the same worlds and gates, and across
the packages: a checkpoint written by either resumes in the other.

1. ``SLAM`` (the host facade) on ``render_sequence``'s 12-frame world at
   step 0.3: 8 frames, save, resume, 4 more frames; the restored map has
   the saved keyframe and landmark counts and the config, at least 3 of the
   4 frames track OK and the state ends OK.
2. The same after the id counters restart at 0 (a new process): the
   restored keyframes keep their frame and keyframe ids, new ids come
   after them, and the map gains keyframes after resume.
3. ``CompiledSLAM`` on the JAX test's 10-frame world: 6 frames, ``flush``,
   save, resume, 4 more frames; the same keyframe count and pose count on
   resume, more poses after, state OK, scale-aligned ATE under 0.35 m.
4. Across the packages on world 3: the JAX package runs frames 0-5 and
   saves; the port resumes that checkpoint (``device="cpu"``) and tracks
   frames 6-9, as does the JAX package from the same checkpoint. The port
   ends OK with a keyframe count within 1 of JAX's and an ATE within
   max(1.5 x JAX's, JAX's + 0.05 m). The other way, the port saves after
   frame 5 and the JAX package resumes it and tracks frames 6-9 to OK.

Without a card, ``resume`` without ``device`` raises. The ``cuda`` case
resumes a checkpoint onto the card (every feature block and the tracking
state there) and tracks on; it skips without a card. JAX is imported only
inside the fixtures that compare with it, so the ``cuda`` case also runs
where JAX is not installed."""
import contextlib
import itertools

import numpy as np
import pytest
import torch

import facade_world as fw
from render import camera_path, make_world, render, render_sequence
from visual_slam_tpu_torch import map as tmap
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.slam import SLAM
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse

F, W, H = 260.0, 320, 240
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
N_SAVE = 6  # world 3: frames 0-5 before the checkpoint
COMPILED_ATE_MAX = 0.35


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def small_config() -> Config:
    return fw.e2e_config(Config)


def _restart_ids():
    """The port's id counters as in a new process."""
    with tmap.frame.FrameBase._ids_lock:
        tmap.frame.FrameBase._ids = itertools.count(0)
    with tmap.KeyFrame._kf_ids_lock:
        tmap.KeyFrame._kf_ids = itertools.count(0)


def _facade_frames():
    frames, Ts_gt, K_, _ = render_sequence(np.random.default_rng(42), n_frames=12, step=0.3)
    return frames, PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K_)


@pytest.fixture(scope="module")
def facade_ckpt(tmp_path_factory):
    """The port's facade after 8 frames, saved."""
    frames, cam = _facade_frames()
    with _threads(2):
        slam = SLAM(cam, small_config(), device="cpu")
        for i in range(8):
            slam.track([frames[i]], timestamp=i * 0.1)
    assert slam.state == State.OK
    path = tmp_path_factory.mktemp("facade") / "ckpt"
    slam.save(path)
    kfs = slam.map.get_keyframes()
    saved = dict(n_kf=len(kfs), n_mp=slam.map.num_map_points(), kf_ids=[k.keyframe_id for k in kfs],
                 frame_ids=[k.id for k in kfs])
    return path, frames, cam, saved


def test_save_and_resume(facade_ckpt):
    path, frames, cam, saved = facade_ckpt
    with _threads(2):
        slam = SLAM.resume(path, cam, device="cpu")
        assert slam.state == State.OK
        assert slam.map.num_keyframes() == saved["n_kf"]
        assert slam.map.num_map_points() == saved["n_mp"]
        assert slam.config.feature.num_features == small_config().feature.num_features
        for owner in (slam.tracking, slam.tracking.initializer, slam.local_mapping, slam.local_mapping.handler,
                      slam.local_handler, slam.global_handler):
            assert owner.map is slam.map
        ok = sum(slam.track([frames[i]], timestamp=i * 0.1).get("state") == "OK" for i in range(8, 12))
    assert slam.state == State.OK
    assert ok >= 3
    assert slam.map.num_keyframes() >= saved["n_kf"]


def test_resume_in_fresh_process_restores_id_counters(facade_ckpt):
    path, frames, cam, saved = facade_ckpt
    _restart_ids()
    with _threads(2):
        slam = SLAM.resume(path, cam, device="cpu")
        kfs = slam.map.get_keyframes()
        assert [k.keyframe_id for k in kfs] == saved["kf_ids"]
        assert [k.id for k in kfs] == saved["frame_ids"]
        assert tmap.Frame().id > max(saved["frame_ids"])
        for i in range(8, 12):
            slam.track([frames[i]], timestamp=i * 0.1)
    assert slam.state == State.OK
    assert slam.map.num_keyframes() > saved["n_kf"], "keyframe creation starved after resume"


def _world3():
    world = make_world(np.random.default_rng(7))
    Ts = camera_path(10, step=0.3)
    return [render(world, T, K, W, H) for T in Ts], Ts


def _ate(slam, Ts_gt) -> float:
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
    return ate_rmse(est, gt, align_scale=True)["rmse"]


def _port_first_half(path, device="cpu"):
    """The port's CompiledSLAM over frames 0-5 of world 3, flushed and
    saved to ``path``."""
    frames, _ = _world3()
    slam = CompiledSLAM(PinholeCamera(width=W, height=H, K=K), small_config(), device=device)
    for i in range(N_SAVE):
        slam.track([frames[i]], timestamp=i * 0.1)
    slam.flush()
    slam.save(path)
    return slam


def _port_second_half(path, device="cpu"):
    frames, _ = _world3()
    slam = CompiledSLAM.resume(path, PinholeCamera(width=W, height=H, K=K), device=device)
    restored = (slam.state, slam.map.num_keyframes(), len(slam.poses))
    for i in range(N_SAVE, len(frames)):
        slam.track([frames[i]], timestamp=i * 0.1)
    slam.flush()
    return slam, restored


def test_compiled_slam_save_resume(tmp_path):
    _, Ts = _world3()
    with _threads(2):
        first = _port_first_half(tmp_path / "ckpt")
        assert first.state == State.OK
        slam, (state, n_kf, n_poses) = _port_second_half(tmp_path / "ckpt")
    assert state == State.OK and n_kf == first.map.num_keyframes() and n_poses == len(first.poses)
    assert slam.state == State.OK
    ts, _ = slam.trajectory()
    assert len(ts) > n_poses
    assert _ate(slam, Ts) < COMPILED_ATE_MAX


def test_resume_goes_on_from_the_last_tracked_frame(tmp_path):
    """The resumed step starts from the last saved frame's pose with the
    last frame-to-frame motion, and counts the frames since the keyframe,
    as the saved system would have (from the keyframe's pose and no motion
    the first frame after a resume loses track on bench_loop_pipeline's
    ring: 1 PnP inlier of 171 matches; the JAX package's resume goes LOST
    there too)."""
    with _threads(2):
        first = _port_first_half(tmp_path / "ckpt")
        slam = CompiledSLAM.resume(tmp_path / "ckpt", PinholeCamera(width=W, height=H, K=K), device="cpu")
    ts, Tw = first.trajectory()
    kf = slam.map.get_last_keyframe()
    np.testing.assert_allclose(slam._track_state.T_w2c.numpy(), Tw[-1], atol=1e-6)
    np.testing.assert_allclose(slam._track_state.T_rel.numpy(), Tw[-1] @ np.linalg.inv(Tw[-2]), atol=1e-5)
    assert slam._frames_since_kf == int((ts > kf.timestamp).sum())
    np.testing.assert_allclose(slam._track_state.ref_feats.xy.numpy(), kf.keypoints(0))


def test_resume_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    with _threads(2):
        _port_first_half(tmp_path / "ckpt")
    cam = PinholeCamera(width=W, height=H, K=K)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledSLAM.resume(tmp_path / "ckpt", cam)
    with pytest.raises(FileNotFoundError):
        CompiledSLAM.resume(tmp_path / "missing", cam, device="cpu")


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """World 3 across the packages: the JAX checkpoint resumed by both, and
    the port's checkpoint resumed by the JAX package."""
    pytest.importorskip("jax")
    from test_slam_e2e import small_config as jax_small_config
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM

    d = tmp_path_factory.mktemp("cross")
    frames, Ts = _world3()
    jcam = JCamera(width=W, height=H, K=K)
    js = JCompiledSLAM(jcam, jax_small_config())
    for i in range(N_SAVE):
        js.track([frames[i]], timestamp=i * 0.1)
    js.flush()
    js.save(d / "jax")

    def jax_resume(path):
        slam = JCompiledSLAM.resume(path, jcam)
        for i in range(N_SAVE, len(frames)):
            slam.track([frames[i]], timestamp=i * 0.1)
        slam.flush()
        return slam

    with _threads(2):
        port, _ = _port_second_half(d / "jax")
        _port_first_half(d / "port")
    return dict(Ts=Ts, saved=js, jax=jax_resume(d / "jax"), port=port, jax_from_port=jax_resume(d / "port"))


def test_port_resumes_jax_checkpoint(cross):
    j, t = cross["jax"], cross["port"]
    assert j.state.name == "OK"
    assert t.state == State.OK
    assert abs(t.map.num_keyframes() - j.map.num_keyframes()) <= 1
    assert t.num_frames_tracked() == j.num_frames_tracked()
    ate_j, ate_t = _ate(j, cross["Ts"]), _ate(t, cross["Ts"])
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ate_t, ate_j)


def test_jax_resumes_port_checkpoint(cross):
    slam = cross["jax_from_port"]
    assert slam.state.name == "OK"
    ts, _ = slam.trajectory()
    assert len(ts) > N_SAVE


@pytest.mark.cuda
def test_resume_onto_the_card(tmp_path):
    """A checkpoint resumed onto the card holds every keyframe's features
    and the tracking state there, and tracks on to OK."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    _port_first_half(tmp_path / "ckpt", device="cuda")
    slam = CompiledSLAM.resume(tmp_path / "ckpt", PinholeCamera(width=W, height=H, K=K))
    assert slam.device.type == "cuda"
    for kf in slam.map.get_keyframes():
        assert all(t.device.type == "cuda" for t in kf.get_features(0))
    assert all(t.device.type == "cuda" for t in slam._track_state.ref_feats)
    assert slam._track_state.lm_pos.device.type == "cuda"
    frames, Ts = _world3()
    for i in range(N_SAVE, len(frames)):
        slam.track([frames[i]], timestamp=i * 0.1)
    slam.flush()
    assert slam.state == State.OK
    assert _ate(slam, Ts) < COMPILED_ATE_MAX
