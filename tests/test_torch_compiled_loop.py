"""Loop closing through the port's ``CompiledSLAM``, held to the JAX package
on ``tests/test_compiled_slam.py``'s self-promoting ring
(``test_compiled_slam_devpromo_loop_closing``): 100 frames of 0.25 m around
a ring of 420 sprites at 320x240, 320 features, chunks of 4 with in-chunk
promotion, loop closing on. Each package runs it once, in module fixtures.

The port starts from the map the JAX package bootstrapped on the same
frames (carried over with ``interop.map_from_numpy``) and pins 2 CPU
threads, as tests/test_torch_compiled_slam.py does for its shared-start
worlds: from its own bootstrap the port tracks this ring and closes the
loop with 1 or 6 intra-op threads, and goes LOST at frame 24 (7 PnP
inliers after 42) with 2-5 or 8, where float rounding decides; the JAX
package resumed from the port's own bootstrap map tracks on.

Gates: the port ends OK without a LOST frame and closes at least one loop;
its scale-aligned ATE is under the JAX test's 0.02 x STEP x N and within
max(1.5 x JAX's, JAX's + 0.05 m); after the closure ``trajectory()`` gives
every keyframe's corrected pose at its frame to 1e-5; the reference block
and landmark arena installed after the closure hold the corrected landmark
positions (to f32 rounding, 1e-6 of the coordinate's size).

The ``cuda`` case (skipped without a card) runs the ring on the card from
the port's own bootstrap, saves after frame 60, resumes and closes the loop
after resuming with K4 launched."""
import contextlib
import itertools

import numpy as np
import pytest
import torch

import loop_pipeline_world as lpw
from visual_slam_tpu_torch import map as tmap
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse

N, STEP = 100, 0.25
F, W, H = 260.0, 320, 240
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
SAVE_AT = 60  # the cuda case's checkpoint: a chunk end, before the revisit


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ring():
    frames, _, Ts = lpw.small_ring_frames(N, STEP)
    return frames, Ts


def _ate(slam, Ts_gt) -> float:
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
    return ate_rmse(est, gt, align_scale=True)["rmse"]


@pytest.fixture(scope="module")
def jax_run(ring):
    """The JAX package over the ring; its bootstrap map (as numpy-carrying
    objects) and the frame after it."""
    pytest.importorskip("jax")
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu_torch import interop

    frames, _ = ring
    js = JCompiledSLAM(JCamera(width=W, height=H, K=K), lpw.small_ring_config(JConfig))
    i = 0
    while js.state.name != "OK":
        js.track([frames[i]], timestamp=i * 0.1)
        i += 1
    boot = interop.map_from_numpy(js.map.get_keyframes(), js.map.get_map_points(), device="cpu")
    for k in range(i, N):
        js.track([frames[k]], timestamp=k * 0.1)
    js.shutdown()
    return js, boot, i


def _bump(owner, attr, nxt):
    setattr(owner, attr, itertools.count(max(next(getattr(owner, attr)), nxt)))


@pytest.fixture(scope="module")
def port_run(ring, jax_run):
    """The port from the JAX bootstrap map, with what the first reference
    install after each closure put on the device."""
    frames, _ = ring
    _, m, start = jax_run
    _bump(tmap.KeyFrame, "_kf_ids", max(k.keyframe_id for k in m.get_keyframes()) + 1)
    _bump(tmap.MapPoint, "_ids", max(p.id for p in m.get_map_points()) + 1)
    _bump(tmap.frame.FrameBase, "_ids", max(k.id for k in m.get_keyframes()) + 1)
    with _threads(2):
        slam = CompiledSLAM(PinholeCamera(width=W, height=H, K=K), lpw.small_ring_config(Config), device="cpu")
        slam.map = slam._initializer.map = slam.loop_closing.map = m
        slam.state = State.OK
        kf = m.get_last_keyframe()
        slam._install_reference(kf, T_init=kf.T_w2c)
        slam.poses.append((((start - 1) * 0.1,), slam._dev_pose(kf.T_w2c), kf, kf.T_w2c.copy()))

        installs = []
        install0 = slam._install_reference

        def install(kf, T_init):
            install0(kf, T_init)
            if len(installs) < len(slam.loop_closing.closed_loops):
                st = slam._track_state
                pos, mask = kf.point_arrays(0)
                arena = np.stack([mp.position for mp in slam._lm_arena])
                installs.append(dict(ref=(st.ref_landmarks.numpy()[mask], pos[mask]),
                                     arena=(st.lm_pos.numpy()[:len(arena)], arena)))

        slam._install_reference = install
        infos = [slam.track([frames[k]], timestamp=k * 0.1) for k in range(start, N)]
        slam.shutdown()
    return slam, infos, installs


def test_port_closes_the_loop(ring, port_run):
    slam, infos, _ = port_run
    assert slam.state == State.OK
    assert not [i for i in infos if i.get("state") == "LOST"]
    assert len(slam.loop_closing.closed_loops) >= 1
    assert _ate(slam, ring[1]) < 0.02 * STEP * N


def test_head_to_head_with_jax(ring, jax_run, port_run):
    js = jax_run[0]
    assert js.state.name == "OK" and len(js.loop_closing.closed_loops) >= 1
    ate_j, ate_t = _ate(js, ring[1]), _ate(port_run[0], ring[1])
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ate_t, ate_j)


def test_trajectory_follows_the_corrected_keyframes(port_run):
    slam = port_run[0]
    assert slam.loop_closing.closed_loops
    ts, Tw = slam.trajectory()
    at = {int(round(t / 0.1)): T for t, T in zip(ts, Tw)}
    kfs = [kf for kf in slam.map.get_keyframes() if int(round(kf.timestamp / 0.1)) in at]
    assert len(kfs) >= 0.8 * slam.map.num_keyframes()
    for kf in kfs:
        np.testing.assert_allclose(at[int(round(kf.timestamp / 0.1))], kf.T_w2c, rtol=0, atol=1e-5)


def test_install_after_the_closure_holds_corrected_landmarks(port_run):
    installs = port_run[2]
    assert installs
    for key in ("ref", "arena"):
        dev, host = installs[0][key]
        assert len(host) > 0
        assert np.abs(dev - host).max() <= 1e-6 * max(1.0, np.abs(host).max()), key


@pytest.mark.cuda
def test_closure_after_resume_launches_k4(ring, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops import match_kernels as mk

    frames, Ts = ring
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = CompiledSLAM(cam, lpw.small_ring_config(Config))
    for k in range(SAVE_AT + 1):
        slam.track([frames[k]], timestamp=k * 0.1)
    slam.flush()
    assert slam.state == State.OK and not slam._chunk_buf
    slam.save(tmp_path / "ckpt")
    slam = CompiledSLAM.resume(tmp_path / "ckpt", cam)
    k4 = mk.hamming_top2_batched.launches
    for k in range(SAVE_AT + 1, N):
        slam.track([frames[k]], timestamp=k * 0.1)
    slam.shutdown()
    assert slam.state == State.OK
    assert len(slam.loop_closing.closed_loops) >= 1
    assert mk.hamming_top2_batched.launches > k4
    assert _ate(slam, Ts) < 0.02 * STEP * N
