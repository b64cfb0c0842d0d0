"""The port's Adam bundle adjustment (``backend/adam.py``) against the JAX
package's (tests/test_adam_ba.py, tests/test_adam_facade.py), on the same
numpy inputs.

``adam_bundle_adjust`` on test_ba.py's problem and on bench.py's (cut to 512
landmarks): cost0, the 150-step cost curve, poses and landmarks within
``ba_world``'s ADAM_* tolerances (two float32 runs sum in different orders,
and Adam's first steps are lr times the gradient's sign, so a component
whose gradient is near zero moves by rounding's choice). The frozen pose
stays put to 1e-6, and LM at 10 iterations beats Adam at 150.

``AdamOptimizer.optimize_local`` and ``optimize_global`` on
test_adam_facade.py's maps, the JAX map carried into the port's by
``interop.map_from_numpy``: the same costs, poses and landmarks, and the
global solve's KF0->KF1 baseline kept to 1e-5 (the re-imposed mono gauge).

``SLAM(..., solver="adam")`` on test_slam_e2e.py's 12-frame world beside
the JAX facade's run, one torch thread pinned: both build their
``AdamOptimizer``, stay OK after the bootstrap, and the port's keyframe ATE
stays within max(1.5x JAX's, JAX's + 0.1) and below 0.5 (the JAX e2e test's
threaded gate). From their own bootstraps the two runs are different
realisations of the world: CPU runs at RANSAC seeds 13 and 0-3 gave
0.156-0.236 for the port and 0.111-0.231 for JAX.

The ``cuda`` case runs the solver on the card against the CPU on bench's
problem and counts its host syncs: none
(``python -m pytest --noconftest -m cuda tests/test_torch_adam.py``; JAX is
imported only in the tests that compare with it).
"""
import contextlib

import numpy as np
import pytest
import torch

import ba_world
from visual_slam_tpu_torch.backend import ba as tba
from visual_slam_tpu_torch.backend.adam import AdamOptimizer, adam_bundle_adjust

F_BENCH = 718.856  # bench.py's focal length: its Huber threshold is 5 px


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _port(problem) -> tba.BAProblem:
    return tba.BAProblem(*[torch.from_numpy(np.array(x)) for x in problem])


def _same_adam(jout, tout):
    (Tj, Xj, ij), (Tt, Xt, it) = jout, tout
    np.testing.assert_allclose(float(it["cost0"]), float(ij["cost0"]), rtol=ba_world.ADAM_COST0_RTOL)
    np.testing.assert_allclose(it["costs"].numpy(), np.asarray(ij["costs"]), rtol=ba_world.ADAM_COSTS_RTOL)
    assert float(it["cost"]) == float(it["costs"][-1])
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=ba_world.ADAM_T_ATOL)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=ba_world.ADAM_X_ATOL)


def _test_ba_problem(rng, **kw):
    from test_ba import make_ba_problem

    return make_ba_problem(rng, **kw)


@pytest.mark.parametrize("world", ["test_ba", "bench"])
def test_adam_bundle_adjust_matches_jax(rng, world):
    import jax.numpy as jnp

    from visual_slam_tpu.backend.adam import adam_bundle_adjust as jadam
    from visual_slam_tpu.backend.ba import BAProblem as JProblem

    if world == "test_ba":
        problem, _, _, f = _test_ba_problem(rng, noise_px=0.2)
    else:
        problem, f = JProblem(**{k: jnp.asarray(v) for k, v in ba_world.bench_problem(M=512).items()}), F_BENCH
    with _threads(1):
        tout = adam_bundle_adjust(_port(problem), n_iter=150, lr=1e-3, huber=5.0 / f)
    jout = jadam(problem, n_iter=150, lr=1e-3, huber=5.0 / f)
    assert tout[2]["costs"].shape == (150,)
    _same_adam(jout, tout)


def test_adam_reduces_cost(rng):
    problem, _, _, f = _test_ba_problem(rng, noise_px=0.2)
    T, X, info = adam_bundle_adjust(_port(problem), n_iter=200, lr=2e-3, huber=5.0 / f)
    assert float(info["cost"]) < float(info["cost0"]) * 0.5
    assert torch.isfinite(T).all() and torch.isfinite(X).all()


def test_adam_keeps_fixed_pose(rng):
    problem, T_gt, _, f = _test_ba_problem(rng)
    T, _, _ = adam_bundle_adjust(_port(problem), n_iter=50, lr=1e-3, huber=5.0 / f)
    np.testing.assert_allclose(T[0].numpy(), T_gt[0], atol=1e-6)


def test_lm_beats_adam_iterations(rng):
    """LM reaches a (much) lower cost in far fewer iterations: the point of
    the second-order solver, in the port as in the JAX package."""
    problem, _, _, f = _test_ba_problem(rng, noise_px=0.2)
    p = _port(problem)
    _, _, lm = tba.bundle_adjust(p, n_iter=10, huber=5.0 / f)
    _, _, adam = adam_bundle_adjust(p, n_iter=150, lr=1e-3, huber=5.0 / f)
    assert float(lm["cost"]) <= float(adam["cost"]) * 1.05


def _facade_maps(rng, n_kf: int):
    """test_adam_facade.py's map: ``n_kf`` keyframes 0.4 m apart observing
    30 landmarks at their exact projections, the landmarks started 0.05 m
    off; the JAX map and the port's copy of it."""
    import jax.numpy as jnp

    from test_map_management import _feats
    from visual_slam_tpu.map import KeyFrame, Map, MapPoint
    from visual_slam_tpu_torch import interop

    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    m = Map()
    pts = np.stack([rng.uniform(-1, 1, 30), rng.uniform(-0.8, 0.8, 30), rng.uniform(4, 8, 30)], 1)
    kfs = []
    for k in range(n_kf):
        T = np.eye(4)
        T[0, 3] = -0.4 * k
        kf = KeyFrame(features=[_feats(rng, 32)], timestamp=0.1 * k)
        kf.update_pose(T)
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = (pc[:, :2] / pc[:, 2:3]) @ K[:2, :2].T + K[:2, 2]
        kf.features = [kf.features[0]._replace(xy=jnp.asarray(np.vstack([uv, np.zeros((2, 2))]), jnp.float32))]
        m.add_keyframe(kf)
        kfs.append(kf)
    for i in range(30):
        mp = MapPoint(pts[i] + rng.normal(0, 0.05, 3))
        for kf in kfs:
            kf.add_map_point(0, i, mp)
        m.add_map_point(mp)
    return K, m, interop.map_from_numpy(m.get_keyframes(), m.get_map_points())


@pytest.mark.parametrize("entry,n_kf,n_iter", [("optimize_local", 2, 100), ("optimize_global", 3, 60)])
def test_adam_optimizer_matches_jax(rng, entry, n_kf, n_iter):
    """Both facades' Adam solve on the same map: costs within the cost
    curve's tolerance, poses and landmarks within ADAM_T_ATOL and
    ADAM_X_ATOL, the map's reprojection error lowered; the global solve
    keeps the KF0->KF1 baseline to 1e-5 in both."""
    from visual_slam_tpu.backend.adam import AdamOptimizer as JAdamOptimizer
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config

    K, jm, tm = _facade_maps(rng, n_kf)
    cfg = JConfig()
    cfg.optimization.solver = "adam"
    cfg.optimization.n_iter = n_iter
    cfg.optimization.lr = 2e-3
    jopt = JAdamOptimizer(cfg, JCamera(320, 240, K))
    topt = AdamOptimizer(Config.from_dict(cfg.to_dict()), PinholeCamera(320, 240, K), device="cpu")
    results, baselines = [], []
    for m, opt in ((jm, jopt), (tm, topt)):
        kfs, mps = m.get_keyframes(), m.get_map_points()
        before = (np.linalg.norm(kfs[1].t_c2w - kfs[0].t_c2w), m.compute_mean_reprojection_error(K))
        with _threads(1):
            results.append(getattr(opt, entry)(kfs, mps))
        after = (np.linalg.norm(kfs[1].t_c2w - kfs[0].t_c2w), m.compute_mean_reprojection_error(K))
        assert results[-1]["cost"] < results[-1]["cost0"] and after[1] < before[1]
        baselines.append((before[0], after[0]))
    jres, tres = results
    assert tres["solver"] == jres["solver"] == "adam"
    assert (tres["n_points"], tres["n_keyframes"]) == (jres["n_points"], jres["n_keyframes"])
    np.testing.assert_allclose(tres["cost0"], jres["cost0"], rtol=ba_world.ADAM_COST0_RTOL)
    np.testing.assert_allclose(tres["cost"], jres["cost"], rtol=ba_world.ADAM_COSTS_RTOL)
    np.testing.assert_allclose(np.stack([k.T_w2c for k in tm.get_keyframes()]),
                               np.stack([k.T_w2c for k in jm.get_keyframes()]), atol=ba_world.ADAM_T_ATOL)
    np.testing.assert_allclose(np.stack([p.position for p in tm.get_map_points()]),
                               np.stack([p.position for p in jm.get_map_points()]), atol=ba_world.ADAM_X_ATOL)
    if entry == "optimize_global":
        for before, after in baselines:
            np.testing.assert_allclose(after, before, rtol=1e-5)
        assert tres["gauge_transform"] is not None


def test_adam_start_dispatch_stays_lm(rng):
    """As in the JAX package, only ``_solve_and_writeback`` is Adam's: the
    ``*_start`` dispatch of ``CompiledSLAM``'s boundary stays the LM/Schur
    solve (its pending handle carries the LM's per-observation outputs)."""
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config

    K, _, tm = _facade_maps(rng, 3)
    cfg = Config()
    cfg.optimization.solver = "adam"
    opt = AdamOptimizer(cfg, PinholeCamera(320, 240, K), device="cpu")
    pending = opt.optimize_global_start(tm.get_keyframes(), tm.get_map_points())
    assert "obs_kept" in pending["info"]
    res = opt.solve_finish(pending)
    assert "solver" not in res and res["cost"] <= res["cost0"]


def test_slam_with_adam_tracks_beside_jax():
    import facade_world as fw
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.slam import SLAM as JSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.slam import SLAM

    frames, K, Ts = fw.e2e_frames(12)
    h, w = frames[0].shape
    out = {}
    for name, cls, cam, conf, kw in (("jax", JSLAM, JCamera, JConfig, {}),
                                     ("port", SLAM, PinholeCamera, Config, {"device": "cpu"})):
        cfg = fw.e2e_config(conf)
        cfg.optimization.solver = "adam"
        with _threads(1):
            slam = cls(cam(width=w, height=h, K=K), cfg, **kw)
            res = fw.run(slam, frames)
            slam.shutdown()
        assert type(slam.optimizer).__name__ == "AdamOptimizer"
        assert slam.local_handler.last_result.get("solver") == "adam"
        s = fw.summary(slam, res, Ts, ate_rmse)
        assert s["state"] == "OK" and s["lost_after_boot"] == 0 and s["keyframes"] >= 3, (name, s)
        out[name] = s["ate_keyframes"]["m"]
    assert out["port"] < 0.5
    assert out["port"] <= max(1.5 * out["jax"], out["jax"] + 0.1), out


@pytest.mark.cuda
def test_adam_on_the_card_matches_the_cpu():
    """bench.py's problem (W = 10, M = 4096) on the card against the CPU
    within the ADAM_* tolerances, with no host sync inside the solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the solver's card path)")
    from visual_slam_tpu_torch.utils.tree import to_device

    p = to_device(tba.BAProblem(**ba_world.bench_problem()), "cpu")
    huber = 5.0 / F_BENCH
    T_c, X_c, i_c = adam_bundle_adjust(p, n_iter=150, lr=1e-3, huber=huber)
    pg = to_device(p, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T_g, X_g, i_g = adam_bundle_adjust(pg, n_iter=150, lr=1e-3, huber=huber)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert float(i_g["cost"]) < 0.5 * float(i_g["cost0"])
    np.testing.assert_allclose(float(i_g["cost0"]), float(i_c["cost0"]), rtol=ba_world.ADAM_COST0_RTOL)
    np.testing.assert_allclose(i_g["costs"].cpu().numpy(), i_c["costs"].numpy(), rtol=ba_world.ADAM_COSTS_RTOL)
    np.testing.assert_allclose(T_g.cpu().numpy(), T_c.numpy(), atol=ba_world.ADAM_T_ATOL)
    np.testing.assert_allclose(X_g.cpu().numpy(), X_c.numpy(), atol=ba_world.ADAM_X_ATOL)
