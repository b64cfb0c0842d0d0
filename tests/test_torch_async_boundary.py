"""Async heavy boundaries (``tracking.async_boundary``) and the deferred
keyframe solve (``optimization.async_ba``) of the port's ``CompiledSLAM``,
held to the JAX package on the CPU.

* The port of ``test_compiled_slam_async_boundary`` (tests/test_compiled_slam.py:368:
  the 17-frame world, chunks of 7 with in-chunk promotion, async on with
  ``async_boundary_min_kfs`` 3): the port starts from the map the JAX package
  bootstrapped on the same frames and pins 2 CPU threads, as
  tests/test_torch_compiled_slam.py does; gates: OK, >= 3 keyframes, >= 14
  frames posed in order, at least one async boundary whose solve landed with
  a device correction, the JAX test's scale-aligned ATE < 0.45 and within
  max(1.5 x, + 0.05 m) of the JAX package's run of the same test.
* The port of ``test_async_boundary_maturity_and_cooloff_gating`` (:553), exact.
* One deferred solve landed in both packages from the same device state,
  the same anchor move and gauge scale: (R_u, t_u, s) and the corrected
  carry (pose, motion model, reference landmarks, arena, reference pose)
  within 1e-6.
* The transitions: sync -> async seeds the device chain from the host;
  async -> sync lands the solve before the sync chunk runs; a reference
  install lands it without a device correction; ``flush`` lands it with one.
* ``async_ba`` on the per-frame path (the 14-frame world), from the JAX
  bootstrap map, against the JAX package's ``CompiledSLAM`` with
  ``async_ba`` on: OK, every deferred solve landed, keyframes within 2 of
  JAX's, both ATEs under 0.45 (see the test for why not the band).

The ``cuda`` case (skipped without a card) runs the small ring
(tests/loop_pipeline_world.py) on the card from the port's own bootstrap
with async boundaries at their default gates: OK, async boundaries ran,
the loop closes, ATE under the JAX test's 0.02 x 0.25 x 100 m. The file
imports JAX only inside the fixtures that compare with it.
"""
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import loop_pipeline_world as lpw
from render import render_sequence
from visual_slam_tpu_torch import pipeline as tpl
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.models import compiled_slam as cs_mod
from visual_slam_tpu_torch.state import State
from visual_slam_tpu_torch.utils.metrics import ate_rmse


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _ate(slam, Ts_gt) -> float:
    ts, Ts = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    return ate_rmse(est, gt, align_scale=True)["rmse"]


def _async_cfg(cfg):
    cfg.tracking.chunk_size = 7
    cfg.tracking.device_promotion = True
    cfg.tracking.async_boundary = True
    cfg.tracking.async_boundary_min_kfs = 3
    return cfg


def _head_to_head(n_frames: int, configure):
    """The JAX package runs the world of ``n_frames`` from its own
    bootstrap; the port continues from a copy of JAX's bootstrap map, with
    every async boundary, every deferred solve landed and every device
    correction counted. Returns (JAX slam, port slam, port infos, counts,
    ground truth)."""
    from test_slam_e2e import small_config as jax_small_config
    from test_torch_compiled_slam import _camera, _port_from_map, small_config
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu_torch import interop

    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(42), n_frames=n_frames, step=0.3)
    js = JCompiledSLAM(_camera(JCamera, frames, K), configure(jax_small_config()))
    i = 0
    while js.state.name != "OK":
        js.track([frames[i]], timestamp=i * 0.1)
        i += 1
    m = interop.map_from_numpy(js.map.get_keyframes(), js.map.get_map_points())
    T_boot, start = np.array(js.map.get_last_keyframe().T_w2c), i
    for k in range(i, len(frames)):
        js.track([frames[k]], timestamp=k * 0.1)
    js.shutdown()
    counts = dict(async_chunks=0, landed=0, corrections=0)
    with _threads(2):
        slam = _port_from_map(m, configure(small_config()), _camera(PinholeCamera, frames, K), T_boot,
                              (start - 1) * 0.1)
        run_async0, finish0, pending_ba0 = slam._run_chunk_devpromo_async, slam._finish_async_solve, \
            slam._apply_pending_ba

        def run_async(*a):
            counts["async_chunks"] += 1
            return run_async0(*a)

        def finish(correct_device):
            landing = slam._async_bnd is not None
            U = finish0(correct_device)
            counts["landed"] += landing
            counts["corrections"] += U is not None
            return U

        def apply_pending_ba():
            counts["landed"] += slam._ba_pending is not None
            return pending_ba0()

        slam._run_chunk_devpromo_async, slam._finish_async_solve = run_async, finish
        slam._apply_pending_ba = apply_pending_ba
        infos = [slam.track([frames[k]], timestamp=k * 0.1) for k in range(start, len(frames))]
        slam.shutdown()
    return js, slam, infos, counts, Ts_gt


@pytest.fixture(scope="module")
def async_run():
    return _head_to_head(17, _async_cfg)


def test_compiled_slam_async_boundary(async_run):
    js, slam, infos, counts, Ts_gt = async_run
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3
    ts, _ = slam.trajectory()
    assert ts.tolist() == sorted(ts.tolist())
    assert slam.num_frames_tracked() == len(ts) >= 14
    assert counts["async_chunks"] >= 1 and counts["landed"] >= 1 and counts["corrections"] >= 1, counts
    assert slam._async_bnd is None  # shutdown landed the last one
    ate_j, ate_t = _ate(js, Ts_gt), _ate(slam, Ts_gt)
    assert ate_t < 0.45
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ate_t, ate_j)


def _gate_slam(min_kfs=5, cooloff=2):
    cfg = Config()
    cfg.tracking.chunk_size = 4  # devpromo (and so async) needs chunks
    cfg.tracking.device_promotion = True
    cfg.tracking.async_boundary = True
    cfg.tracking.async_boundary_min_kfs = min_kfs
    cfg.tracking.async_boundary_cooloff = cooloff
    return CompiledSLAM(PinholeCamera(width=320, height=240, K=np.diag([300.0, 300.0, 1.0])), cfg, device="cpu")


def test_async_boundary_maturity_and_cooloff_gating():
    """Sync while the map is young, async once mature, and sync again for
    ``async_boundary_cooloff`` boundaries after thin tracking."""
    slam = _gate_slam()

    class _FakeMap:
        def __init__(self, n):
            self.n = n

        def num_keyframes(self):
            return self.n

    slam.map = _FakeMap(3)
    assert slam._use_async_boundary() is False  # young map
    slam.map = _FakeMap(8)
    assert slam._use_async_boundary() is True  # mature
    slam._async_cooloff = 2  # thin-tracking chunk fired the cooloff
    assert slam._use_async_boundary() is False
    assert slam._use_async_boundary() is False
    assert slam._use_async_boundary() is True  # cooloff consumed
    slam._async_mode = False
    assert slam._use_async_boundary() is False  # master switch off


# -------------------------------------------------- one deferred solve landed
def _carry(seed: int = 3, K: int = 64, M: int = 96):
    """A JAX TrackState with a moved pose, a motion model, a reference block
    and an arena, and a reference pose, from numpy draws."""
    import jax.numpy as jnp

    from visual_slam_tpu.ops.detector import Features
    from visual_slam_tpu.pipeline import init_track_state, set_local_map

    rng = np.random.default_rng(seed)
    feats = Features(xy=jnp.asarray(rng.uniform(0, 300, (K, 2)), jnp.float32), response=jnp.ones(K),
                     angle=jnp.zeros(K), octave=jnp.zeros(K, jnp.int32), size=jnp.ones(K),
                     desc=jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32)),
                     valid=jnp.ones(K, bool))

    def pose(t):
        a = rng.normal(0, 0.1, 3)
        c, s = np.cos(a[1]), np.sin(a[1])
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = t
        return T

    st = init_track_state(feats, rng.normal(0, 5, (K, 3)).astype(np.float32), rng.random(K) < 0.7,
                          pose(rng.normal(0, 1, 3)), local_map_size=M)
    st = set_local_map(st, rng.normal(0, 5, (M, 3)).astype(np.float32),
                       rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32), rng.random(M) < 0.8)
    st = st._replace(T_rel=jnp.asarray(pose([0.1, 0.0, 0.3]), jnp.float32))
    T_pre, T_new = pose(rng.normal(0, 1, 3)), pose(rng.normal(0, 1, 3))
    return st, pose(rng.normal(0, 1, 3)).astype(np.float32), T_pre, T_new


def test_deferred_solve_matches_jax():
    """The same pending result (the anchor's pose T_pre -> T_new, gauge
    scale 1.07) landed on the same device state in both packages."""
    from test_slam_e2e import small_config as jax_small_config
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu_torch.interop import track_state_from_numpy

    st, T_ref, T_pre, T_new = _carry()
    g = (1.07, np.array([0.2, -0.1, 0.05]))
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            slam = JCompiledSLAM(JCamera(width=320, height=240, K=K), _async_cfg(jax_small_config()))
            import jax.numpy as jnp

            slam._track_state, slam._dev_T_ref = st, jnp.asarray(T_ref)
        else:
            slam = CompiledSLAM(PinholeCamera(width=320, height=240, K=K),
                                _async_cfg(Config.from_dict(jax_small_config().to_dict())), device="cpu")
            slam._track_state, slam._dev_T_ref = track_state_from_numpy(st), torch.from_numpy(T_ref)
        anchor = SimpleNamespace(T_w2c=T_pre.copy())

        def solve_finish(pending, anchor=anchor):
            anchor.T_w2c = T_new.copy()  # what the writeback does to the anchor
            return {"gauge_transform": g}

        slam.optimizer.solve_finish = solve_finish
        slam._async_bnd = {"pending": object(), "anchor": anchor, "T_pre": T_pre.copy()}
        U = slam._finish_async_solve(correct_device=True)
        s_ = slam._track_state
        out[name] = dict(U=U, T=np.asarray(s_.T_w2c), T_rel=np.asarray(s_.T_rel), ref=np.asarray(s_.ref_landmarks),
                         lm=np.asarray(s_.lm_pos), T_ref=np.asarray(slam._dev_T_ref), log=slam.map.gauge_version)
        assert slam._async_bnd is None
    j, t = out["jax"], out["port"]
    assert t["U"] is not None and t["U"][2] == j["U"][2] == g[0]
    np.testing.assert_allclose(t["U"][0], j["U"][0], atol=1e-12)
    np.testing.assert_allclose(t["U"][1], j["U"][1], atol=1e-12)
    for k in ("T", "T_rel", "ref", "lm", "T_ref"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-6 * max(1.0, np.abs(j[k]).max()), err_msg=k)
    assert t["log"] == j["log"] == 1  # the gauge similarity was recorded


# ------------------------------------------------------------ transitions
def _landing(slam, T_new, g=None):
    """A solve in flight on ``slam`` whose writeback moves a stand-in anchor
    to ``T_new``; returns the list its landings are logged in."""
    log = []
    anchor = SimpleNamespace(T_w2c=np.eye(4))

    def finish_ba(pending):
        log.append(pending)
        anchor.T_w2c = T_new.copy()
        return g

    slam._finish_ba = finish_ba
    slam._async_bnd = {"pending": "solve", "anchor": anchor, "T_pre": np.eye(4)}
    return log


def _moved():
    T = np.eye(4)
    T[:3, 3] = [0.3, -0.2, 0.1]
    return T


def test_sync_to_async_seeds_the_device_chain(async_run):
    slam = async_run[1]
    seen = {}

    def run_async(imgs, buf, n):
        seen.update(fsr=int(slam._dev_fsr), T_ref=slam._dev_T_ref.numpy().copy())
        return {}

    slam._run_chunk_devpromo_async = run_async
    slam._use_async_boundary = lambda: True
    slam._prev_chunk_async = False
    slam._frames_since_kf = 3
    slam._chunk_buf = [(np.zeros((4, 4), np.float32), 9.9)]
    slam._run_chunk()
    assert seen["fsr"] == 3
    np.testing.assert_allclose(seen["T_ref"], slam._ref_kf.T_w2c.astype(np.float32))
    assert slam._prev_chunk_async


def test_async_to_sync_lands_the_solve_first(async_run):
    slam = async_run[1]
    log = _landing(slam, _moved())
    T_before = slam._track_state.T_w2c.clone()
    order = []

    def run_sync(imgs, buf, n):
        order.append(("sync chunk", slam._async_bnd is None, len(log)))
        return {}

    slam._run_chunk_devpromo = run_sync
    slam._use_async_boundary = lambda: False
    slam._prev_chunk_async = True
    slam._chunk_buf = [(np.zeros((4, 4), np.float32), 9.9)]
    slam._run_chunk()
    assert order == [("sync chunk", True, 1)]
    assert not torch.equal(slam._track_state.T_w2c, T_before)  # the device correction was applied


def test_install_reference_lands_without_a_correction(async_run, monkeypatch):
    slam = async_run[1]
    log = _landing(slam, _moved())

    def no_correction(*a, **k):
        raise AssertionError("apply_correction called")

    monkeypatch.setattr(cs_mod, "apply_correction", no_correction)
    kf = slam._ref_kf
    slam._install_reference(kf, T_init=kf.T_w2c)
    assert log == ["solve"] and slam._async_bnd is None


@pytest.mark.parametrize("call", ["flush", "shutdown"])
def test_flush_and_shutdown_land_the_solve(async_run, call):
    slam = async_run[1]
    log = _landing(slam, _moved())
    T_before = slam._track_state.T_w2c.clone()
    getattr(slam, call)()
    assert log == ["solve"] and slam._async_bnd is None
    assert not torch.equal(slam._track_state.T_w2c, T_before)


def test_correction_uploads_without_a_sync():
    """``apply_correction`` takes host numpy and returns the state on the
    state's device with float32 leaves (the device chain stays float32)."""
    st = tpl.init_track_state(
        tpl.Features(xy=torch.zeros(4, 2), response=torch.ones(4), angle=torch.zeros(4),
                     octave=torch.zeros(4, dtype=torch.int32), size=torch.ones(4),
                     desc=torch.zeros(4, 8, dtype=torch.int32), valid=torch.ones(4, dtype=torch.bool)),
        np.zeros((4, 3), np.float32), np.ones(4, bool), np.eye(4), device="cpu")
    st2, T_ref = tpl.apply_correction(st, torch.eye(4), np.eye(3), np.array([1.0, 0.0, 0.0]), 2.0)
    assert st2.T_w2c.dtype == T_ref.dtype == torch.float32
    np.testing.assert_allclose(st2.T_w2c[:3, 3].numpy(), [-1.0, 0.0, 0.0])


# ---------------------------------------------------------------- async_ba
def _async_ba_cfg(cfg):
    cfg.optimization.async_ba = True
    return cfg


def test_async_ba_per_frame_head_to_head():
    """The per-frame path's 14 frames are too few for the other tests' ATE
    band: with the same start the port's synchronous run ends at 0.054-0.073
    m and JAX's at 0.164, and the thread count alone moves the port's
    ``async_ba`` run from 0.180 to 0.397 (JAX: 0.132; one more keyframe).
    So both packages are held to the gate of the JAX package's own
    ``async_ba`` record (config.py: ATE 0.45 async against 0.24 sync on the
    small render world), which is the JAX tests' compiled-path gate, and the
    keyframe counts to within 2."""
    js, slam, infos, counts, Ts_gt = _head_to_head(14, _async_ba_cfg)
    assert slam.state == State.OK, [i.get("state") for i in infos]
    assert js.state.name == "OK"
    assert counts["landed"] >= 1 and slam._ba_pending is None
    assert any(i.get("new_keyframe") for i in infos)
    assert abs(slam.map.num_keyframes() - js.map.num_keyframes()) <= 2
    ate_j, ate_t = _ate(js, Ts_gt), _ate(slam, Ts_gt)
    assert ate_j < 0.45 and ate_t < 0.45, (ate_t, ate_j)


@pytest.mark.cuda
def test_async_ring_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    frames, K, Ts = lpw.small_ring_frames()
    cfg = lpw.small_ring_config(Config)
    cfg.tracking.async_boundary = True
    slam = CompiledSLAM(PinholeCamera(width=320, height=240, K=K), cfg)
    n_async = 0
    run0 = slam._run_chunk_devpromo_async

    def run_async(*a):
        nonlocal n_async
        n_async += 1
        return run0(*a)

    slam._run_chunk_devpromo_async = run_async
    for i, img in enumerate(frames):
        slam.track([img], timestamp=i * 0.1)
    slam.shutdown()
    assert slam.state == State.OK
    assert n_async >= 1
    assert len(slam.loop_closing.closed_loops) >= 1
    assert _ate(slam, Ts) < 0.02 * 0.25 * len(frames)
