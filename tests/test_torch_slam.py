"""The port's ``SLAM`` facade end to end on the CPU, held to the JAX
package's own facade gates (tests/test_slam_e2e.py, tests/test_relocalization.py).

Synchronous, on test_slam_e2e.py's 12-frame world and ``small_config``:
state OK after the bootstrap, at least 3 keyframes and more than 100
landmarks, keyframe ATE below 0.25 (scale-aligned), mean reprojection
error below 2 px, ``reset`` clearing the state, and two runs in one
process identical. Threaded: the same world through ``SLAM(threaded=True)``,
keyframe ATE below 0.50, the JAX test's gate, set from the port's own
spread: 27 threaded CPU runs with scripts/facade_reference.py (``--world
e2e --threaded``) gave 0.029-0.082 in 24 runs, and 0.123, 0.360 and 0.388
in three runs made while other CPU-heavy jobs shared the machine (the
threads' interleaving decides which keyframes local BA sees). The JAX
package's 8 runs under that load gave 0.091-0.729: the gate is knife-edge
for it, not for the port.
Relocalization: blank frames send the system LOST and the next real view
relocalizes it; the global-signature shortlist ranks an early keyframe
first for an early view (on the JAX facade's map, see the test).
"""
import numpy as np
import pytest
import torch

import facade_world as fw
from render import render_sequence
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.slam import SLAM
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse, trajectory_from_keyframes

THREADED_ATE_MAX = 0.50


def small_config() -> Config:
    return fw.e2e_config(Config)


def _camera(frames, K):
    return PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)


def _kf_ate(slam, Ts_gt) -> float:
    kfs = slam.map.get_keyframes()
    idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    return ate_rmse(trajectory_from_keyframes(kfs), gt, align_scale=True)["rmse"]


def _run(n_frames=12, threaded=False):
    frames, K, Ts_gt = fw.e2e_frames(n_frames)
    slam = SLAM(_camera(frames, K), small_config(), threaded=threaded, device="cpu")
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()
    return slam, infos, Ts_gt


@pytest.fixture(scope="module")
def slam_run():
    torch.set_num_threads(2)
    return _run()


def test_initializes_and_tracks(slam_run):
    """The port's own run bootstraps and ends OK; from the JAX package's
    bootstrap (its state after frames 0-1, carried over by
    tests/facade_parity.py) the port then tracks every frame OK, as the
    JAX facade does from there. From its own bootstrap the port's run is a
    different realisation of this world (its RANSAC draws are its own),
    and on an AMD EPYC (Zen 4, MKL 2024.2) that realisation lost frame 6
    (7 PnP inliers) and relocalized at frame 7, while with
    MKL_CBWR=COMPATIBLE it bootstrapped a frame later and stayed OK: so
    "OK for good" is held from the shared bootstrap."""
    import facade_parity as fp

    slam, infos, _ = slam_run
    assert slam.state == State.OK, [i.get("state") for i in infos]
    assert "OK" in [i["state"] for i in infos]
    torch.set_num_threads(2)
    frames, _, K = fp.world()
    jcfg, cfg = fp.configs()
    js = fp.jax_slam(frames, K, jcfg, 2)
    assert js.state.name == "OK"
    ts = fp.port_from(js, frames, K, cfg)
    for name, s in (("jax", js), ("port", ts)):
        states = [s.track([frames[i]], timestamp=i * 0.1)["state"] for i in range(2, len(frames))]
        s.shutdown()
        assert states == ["OK"] * len(states), (name, states)


def test_map_grows(slam_run):
    slam, _, _ = slam_run
    assert slam.map.num_keyframes() >= 3
    assert slam.map.num_map_points() > 100


def test_trajectory_ate(slam_run):
    slam, _, Ts_gt = slam_run
    assert _kf_ate(slam, Ts_gt) < 0.25


def test_reprojection_error_small(slam_run):
    slam, _, _ = slam_run
    assert slam.map.compute_mean_reprojection_error(slam.camera.K) < 2.0


def test_trajectory_and_metrics(slam_run):
    slam, _, _ = slam_run
    traj = slam.trajectory()
    assert len(traj) == slam.map.num_keyframes()
    assert [t for _, t, _ in traj] == sorted(t for _, t, _ in traj)
    m = slam.metrics()
    assert m["state"] == "OK" and m["num_keyframes"] == len(traj) and m["loops_closed"] == 0
    assert m["last_ba"]["cost"] <= m["last_ba"]["cost0"]


def test_reset(slam_run):
    slam, _, _ = slam_run
    slam.reset()
    assert slam.state == State.NO_IMAGES_YET
    assert slam.map.num_keyframes() == 0
    assert slam.map.num_map_points() == 0


def test_run_to_run_determinism():
    a, _, _ = _run(10)
    b, _, _ = _run(10)
    assert a.map.num_map_points() == b.map.num_map_points()
    np.testing.assert_array_equal(np.stack([k.T_w2c for k in a.map.get_keyframes()]),
                                  np.stack([k.T_w2c for k in b.map.get_keyframes()]))


def test_threaded_mode_e2e():
    slam, infos, Ts_gt = _run(threaded=True)
    assert slam.state == State.OK, [i.get("state") for i in infos]
    assert slam.map.num_keyframes() >= 3
    assert slam.local_mapping.failures == slam.local_handler.failures == slam.global_handler.failures == 0
    assert _kf_ate(slam, Ts_gt) < THREADED_ATE_MAX


def test_lost_and_relocalize():
    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(7), n_frames=10, step=0.3)
    slam = SLAM(_camera(frames, K), small_config(), device="cpu")
    for i in range(7):
        slam.track([frames[i]], timestamp=i * 0.1)
    assert slam.state == State.OK
    blank = np.full_like(frames[0], 100.0)
    for k in range(2):
        slam.track([blank], timestamp=(7 + k) * 0.1)
    assert slam.state == State.LOST
    info = slam.track([frames[7]], timestamp=1.1)
    assert slam.state == State.OK, info
    assert info.get("relocalized", False)
    slam.track([frames[8]], timestamp=1.2)
    assert slam.state == State.OK


def test_global_candidates_rank_matching_view_first():
    """On the map the JAX facade builds with a keyframe per frame (carried
    over with ``interop.install_slam_state``), the port's own detection of
    an early view must rank an early keyframe first. (The port's own run of
    this world bootstraps from frames 0 and 2, leaving no keyframe at frame
    1; its centred signature scores of the old keyframes then lie within
    noise of each other: measured 0.29 for frame 0 against 0.47 for frame
    5, so which keyframe tops the list follows the bootstrap, not the
    shortlist.)"""
    import facade_parity as fp

    frames, Ts_gt, K = fp.world(n_frames=12, seed=9, step=0.3)
    jcfg, cfg = fp.configs(tracking__keyframe_interval=1)
    js = fp.jax_slam(frames, K, jcfg, 12)
    slam = fp.port_from(js, frames, K, cfg)
    tr = slam.tracking
    kfs = slam.map.get_keyframes()
    assert len(kfs) >= 8
    frame = tr._create_frame([frames[1]], timestamp=99.0, depth=None)
    cands = tr._reloc_global_candidates(frame, exclude={kf.keyframe_id for kf in kfs[-5:]}, top_n=3)
    assert cands
    assert cands[0].timestamp <= 0.45, [c.timestamp for c in cands]


def test_fused_pipeline_tracks():
    """``tracking.fused_pipeline``: FusedMonoTracking's one-step frames."""
    frames, K, Ts_gt = fw.e2e_frames(10)
    cfg = small_config()
    cfg.tracking.fused_pipeline = True
    slam = SLAM(_camera(frames, K), cfg, device="cpu")
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()
    states = [i["state"] for i in infos]
    assert all(s == "OK" for s in states[states.index("OK"):]), states
    assert any("n_guided" in i for i in infos)
    assert slam.map.num_keyframes() >= 3
    assert _kf_ate(slam, Ts_gt) < 0.25


@pytest.mark.parametrize("section,key,value", [
    ("optimization", "solver", "adam"),
    ("feature", "ragged_descriptors", True),
])
def test_unported_switches_raise(section, key, value):
    """Ragged descriptors (a layout for the TPU's tiling) raise.
    ``solver="adam"`` is ported: the facade builds what the JAX package's
    builds for that configuration, its ``AdamOptimizer``, on the device
    asked for."""
    cfg = small_config()
    setattr(getattr(cfg, section), key, value)
    camera = PinholeCamera(width=320, height=240, K=np.diag([300.0, 300.0, 1.0]))
    if key != "solver":
        with pytest.raises(NotImplementedError):
            SLAM(camera, cfg, device="cpu")
        return
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.slam import SLAM as JSLAM
    from visual_slam_tpu_torch.backend.adam import AdamOptimizer

    js = JSLAM(JCamera(width=320, height=240, K=np.diag([300.0, 300.0, 1.0])), JConfig.from_dict(cfg.to_dict()))
    slam = SLAM(camera, cfg, device="cpu")
    assert type(slam.optimizer).__name__ == type(js.optimizer).__name__ == "AdamOptimizer"
    assert isinstance(slam.optimizer, AdamOptimizer) and slam.optimizer.device.type == "cpu"
    slam.shutdown()
    js.shutdown()


def test_save_and_resume_raise(tmp_path):
    """Save and resume of the port's facade (they raised before the
    checkpoint files were ported; the name is kept): the map after the
    12-frame run comes back with its keyframes, landmarks, ids and motion
    model, OK, and without a card and a device ``resume`` raises."""
    torch.set_num_threads(2)
    slam = _run()[0]
    slam.save(tmp_path / "ckpt")
    back = SLAM.resume(tmp_path / "ckpt", slam.camera, device="cpu")
    assert back.state == State.OK
    assert [k.keyframe_id for k in back.map.get_keyframes()] == [k.keyframe_id for k in slam.map.get_keyframes()]
    assert back.map.num_map_points() == slam.map.num_map_points()
    np.testing.assert_allclose(back.tracking.motion_model, slam.tracking.motion_model)
    assert back.tracking.last_keyframe_frame_id == slam.tracking.last_keyframe_frame_id
    assert back.tracking.reference_keyframe is back.map.get_last_keyframe()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SLAM.resume(tmp_path / "ckpt", slam.camera)
