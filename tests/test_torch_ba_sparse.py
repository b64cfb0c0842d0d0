"""The port's sparse landmark-major bundle adjustment and its optimizer
facade (``optimization.sparse_obs``) against the JAX package on the CPU, on
``tests/test_ba.py``'s worlds.

Tolerances: within the port, sparse against dense as the JAX package holds
its own pair (poses 2e-4, points 2e-3, cost 1e-3 relative: the same math
summed in another order); port against JAX on the same sparse problem as
the dense pair in tests/test_torch_ba.py (one linear solve within 1e-4 of
the step's size; an LM stage poses 1e-4, points 1e-3; after the two-stage
robust solve costs within 1e-3 relative and the trimmed mask exactly, the
poses within 1e-2, since the second stage's steps sit at the float32
rounding of the cost: see ``test_bundle_adjust_robust_sparse_matches_jax``). The pack's
integer arrays (pose slot, keypoint index, validity) equal JAX's exactly.
End to end, the port's self-promoting ``CompiledSLAM`` with every solve
sparse, from the JAX package's bootstrap map, holds the JAX run's ATE
band (max(1.5 x JAX's, JAX's + 0.05)) and the JAX test's 0.45 gate.

The ``cuda`` case (skipped without a card) solves a (16, 4096, 16) problem of
``tests/ba_world.py`` whose landmarks are each seen by all 16 poses, two of
them fixed, on the card and on the CPU: costs within 1e-3 relative, poses
within 1e-4. The script's own shapes chain the poses by tracks of 4 and are
ill-conditioned: the CPU's thread count alone moves their poses by more
than 1e-3, so ``chip_smoke.py`` times them and compares costs only. The
file imports JAX only inside the tests that compare with it, so the card's
machine, which has no JAX, collects the ``cuda`` case.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ba_world
from visual_slam_tpu_torch.backend import ba as tba
from visual_slam_tpu_torch.backend.optimizer import LMOptimizer
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.utils.tree import to_device

torch.set_num_threads(1)


ROBUST_POSE_ATOL = 1e-2  # the whole two-stage solve; see the test's docstring


def _jax():
    """(jax.numpy, the JAX package's ba module, make_ba_problem, to_sparse)."""
    import jax.numpy as jnp

    from test_ba import make_ba_problem, to_sparse
    from visual_slam_tpu.backend import ba as jba

    return jnp, jba, make_ba_problem, to_sparse


def _port(sparse) -> tba.BASparse:
    """The port's BASparse from a JAX one."""
    return to_device(tba.BASparse(*[np.array(a) for a in sparse]), "cpu")


def _dense(problem) -> tba.BAProblem:
    return to_device(tba.BAProblem(*[np.array(a) for a in problem]), "cpu")


def test_sparse_matches_dense(rng):
    jnp, jba, make_ba_problem, to_sparse = _jax()
    problem, _, _, f = make_ba_problem(rng, W=5, M=150, n_fixed=2)
    Td, Xd, infod = tba.bundle_adjust(_dense(problem), n_iter=15, huber=5.0 / f)
    Ts, Xs, infos = tba.bundle_adjust_sparse(_port(to_sparse(problem, K=5)), n_iter=15, huber=5.0 / f)
    np.testing.assert_allclose(Ts.numpy(), Td.numpy(), atol=2e-4)
    np.testing.assert_allclose(Xs.numpy(), Xd.numpy(), atol=2e-3)
    np.testing.assert_allclose(float(infos["cost"]), float(infod["cost"]), rtol=1e-3)


def test_sparse_robust_matches_dense(rng):
    jnp, jba, make_ba_problem, to_sparse = _jax()
    problem, T_gt, _, f = make_ba_problem(rng, noise_px=0.2, n_fixed=2)
    uv = np.asarray(problem.uv).copy()
    n_bad = len(uv) // 10
    uv[:n_bad, :, :] += rng.uniform(-0.2, 0.2, (n_bad, uv.shape[1], 2))
    problem = problem._replace(uv=jnp.asarray(uv))
    _, _, infod = tba.bundle_adjust_robust(_dense(problem), n_iter=12, n_iter2=12, huber=3.0 / f)
    Ts, _, infos = tba.bundle_adjust_robust_sparse(_port(to_sparse(problem, K=4)), n_iter=12, n_iter2=12,
                                                   huber=3.0 / f)
    assert int(infos["n_trimmed"]) > 0
    np.testing.assert_allclose(Ts.numpy()[:, :3, :3], T_gt[:, :3, :3], atol=5e-3)
    np.testing.assert_allclose(Ts.numpy()[:, :3, 3], T_gt[:, :3, 3], atol=3e-2)
    assert int(infos["n_trimmed"]) == int(infod["n_trimmed"])


def test_sparse_obs_cap_overflow_still_converges(rng):
    """K under the longest track: the subset solve still lowers the cost
    and stays near the truth."""
    jnp, jba, make_ba_problem, to_sparse = _jax()
    problem, T_gt, _, f = make_ba_problem(rng, W=6, M=150, n_fixed=2)
    Ts, _, infos = tba.bundle_adjust_sparse(_port(to_sparse(problem, K=3)), n_iter=15, huber=5.0 / f)
    assert float(infos["cost"]) < float(infos["cost0"])
    np.testing.assert_allclose(Ts.numpy()[:, :3, 3], T_gt[:, :3, 3], atol=1e-1)


def test_sparse_handles_empty_slots(rng):
    jnp, jba, make_ba_problem, to_sparse = _jax()
    problem, _, _, f = make_ba_problem(rng, W=4)
    sparse = to_sparse(problem, K=4)
    s_valid = np.asarray(sparse.obs_valid).copy()
    s_valid[-20:, :] = False
    sparse = sparse._replace(obs_valid=jnp.asarray(s_valid), pose_valid=jnp.asarray([True, True, True, False]))
    T, X, info = tba.bundle_adjust_sparse(_port(sparse), n_iter=10, huber=5.0 / f)
    assert np.isfinite(T.numpy()).all() and np.isfinite(X.numpy()).all()
    assert float(info["cost"]) <= float(info["cost0"])


def test_sparse_obs_auto_selects_by_window(monkeypatch):
    """``sparse_obs="auto"`` packs the sparse layout once the pose bucket
    reaches ``sparse_auto_min_window``, as the JAX package does off the TPU."""
    cfg = Config()
    cfg.optimization.sparse_obs = "auto"
    cfg.optimization.sparse_auto_min_window = 32
    opt = LMOptimizer(cfg, SimpleNamespace(K=np.diag([300.0, 300.0, 1.0])), device="cpu")

    class _Stop(Exception):
        pass

    calls = []

    def fake(name):
        def pack(*a, **k):
            calls.append(name)
            raise _Stop
        return pack

    monkeypatch.setattr(opt, "_pack", fake("dense"))
    monkeypatch.setattr(opt, "_pack_sparse", fake("sparse"))
    for w_bucket in (16, 32):
        with pytest.raises(_Stop):
            opt.solve_start([], [], w_bucket)
    assert calls == ["dense", "sparse"]


def test_solve_step_sparse_matches_jax():
    jnp, jba, make_ba_problem, to_sparse = _jax()
    problem, _, _, _ = make_ba_problem(np.random.default_rng(0), W=5, M=150)
    sp = to_sparse(problem, K=4)
    W = problem.T_w2c.shape[0]
    w = np.asarray(sp.obs_valid, np.float32)
    free = np.asarray(problem.pose_valid & ~problem.pose_fixed, np.float32)
    onehot_j = jba._pose_onehot(sp.obs_pose, W)
    pf_obs = jnp.einsum("mkw,w->mk", onehot_j, jnp.asarray(free))
    dxi_j, dX_j = jba._solve_step_sparse(sp.T_w2c, sp.points, sp.uv, onehot_j, pf_obs, jnp.asarray(w),
                                         jnp.asarray(free), jnp.float32(1e-3), 5.0 / 500.0)
    p = _port(sp)
    pose = p.obs_pose.long()
    onehot_t = torch.nn.functional.one_hot(pose.reshape(-1), W).float()
    dxi_t, dX_t = tba._solve_step_sparse(p.T_w2c, p.points, p.uv, pose, onehot_t, torch.from_numpy(w),
                                         torch.from_numpy(free), torch.tensor(1e-3), 5.0 / 500.0)
    dxi_j, dX_j = np.asarray(dxi_j), np.asarray(dX_j)
    assert np.isfinite(dxi_j).all() and np.abs(dxi_j).max() > 1e-3  # a real step
    np.testing.assert_allclose(dxi_t.numpy(), dxi_j, atol=1e-4 * np.abs(dxi_j).max())
    np.testing.assert_allclose(dX_t.numpy(), dX_j, atol=1e-4 * np.abs(dX_j).max())


@pytest.mark.parametrize("case", [
    dict(),  # one gauge camera, 0.3 px noise, every track in its K slots
    dict(noise_px=0.05, n_fixed=2, W=6, M=200, K=4),  # tracks cut at 4 of 6
    dict(outliers=12),  # gross outliers that the interim trim must drop
])
def test_bundle_adjust_robust_sparse_matches_jax(case):
    """The first stage from the same start holds poses to 1e-4 and points to
    1e-3; the whole two-stage solve holds the costs, the trimmed mask and
    the poses to ROBUST_POSE_ATOL. The second stage starts at the first's
    minimum, where a step gains ~4e-10 of a 1.13e-4 cost (case 0) and the
    float32 rounding of evaluating the cost is as large: either package's
    cost function scores the same step +1.2e-10 or -5e-11 where float64
    says -4.3e-10. Accept or reject is a coin flip there in both packages,
    and the poses wander along the flat direction by up to 7.8e-3 (case 0,
    one gauge camera, where scale is free; 5.8e-4 with two)."""
    jnp, jba, make_ba_problem, to_sparse = _jax()
    case = dict(case)
    n_out, K = case.pop("outliers", 0), case.pop("K", 4)
    rng = np.random.default_rng(1)
    problem, _, _, _ = make_ba_problem(rng, **case)
    if n_out:
        uv = np.array(problem.uv)
        rows = rng.choice(uv.shape[0], n_out, replace=False)
        uv[rows, 1] += 40.0 / 500.0  # 40 px off in the second camera
        problem = problem._replace(uv=jnp.asarray(uv))
    sp = to_sparse(problem, K=K)
    huber = 5.0 / 500.0
    T1j, X1j, _ = jba.bundle_adjust_sparse(sp, n_iter=8, huber=huber)
    T1t, X1t, _ = tba.bundle_adjust_sparse(_port(sp), n_iter=8, huber=huber)
    np.testing.assert_allclose(T1t.numpy(), np.asarray(T1j), atol=1e-4)
    np.testing.assert_allclose(X1t.numpy(), np.asarray(X1j), atol=1e-3)
    Tj, Xj, ij = jba.bundle_adjust_robust_sparse(sp, n_iter=8, n_iter2=8, huber=huber)
    Tt, Xt, it = tba.bundle_adjust_robust_sparse(_port(sp), n_iter=8, n_iter2=8, huber=huber)
    c0, c = float(ij["cost0"]), float(ij["cost"])
    assert c < 0.5 * c0
    np.testing.assert_allclose(float(it["cost0"]), c0, rtol=1e-5)
    np.testing.assert_allclose(float(it["cost"]), c, rtol=1e-3)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=ROBUST_POSE_ATOL)
    np.testing.assert_array_equal(it["obs_kept"].numpy(), np.asarray(ij["obs_kept"]))
    assert int(it["n_trimmed"]) == int(ij["n_trimmed"]) >= n_out
    rn_j = np.asarray(jba.residual_norms_sparse(Tj, Xj, sp.uv, sp.obs_pose, sp.obs_valid))
    rn_t = tba.residual_norms_sparse(Tt, Xt, *_port(sp)[2:5]).numpy()
    np.testing.assert_array_equal(np.isinf(rn_t), np.isinf(rn_j))


class _Obs:
    def __init__(self, triples):
        self._t = triples

    def items(self):
        return list(self._t)


def _fake_window(seed: int = 5, W: int = 6, M: int = 40, n_kp: int = 64):
    """Duck-typed keyframes (``keyframe_id``, ``T_w2c``, ``keypoints``) and
    landmarks (``position``, ``observations.items()``) as both packages'
    ``_pack_sparse`` read them: tracks of 1-9 observations, some in a
    second camera or in keyframes outside the window."""
    rng = np.random.default_rng(seed)
    kfs = []
    for j in range(W):
        T = np.eye(4)
        T[:3, 3] = rng.normal(0, 0.5, 3)
        xy = rng.uniform(0, 320, (n_kp, 2))
        kfs.append(SimpleNamespace(keyframe_id=10 + j, T_w2c=T, keypoints=lambda cam, xy=xy: xy))
    pts = []
    for _ in range(M):
        n = int(rng.integers(1, 10))
        triples = [(int(10 + rng.integers(0, W + 3)), int(rng.integers(0, 5) == 0), int(rng.integers(0, n_kp)))
                   for _ in range(n)]
        pts.append(SimpleNamespace(position=rng.normal(0, 3, 3), observations=_Obs(triples)))
    return kfs, pts


@pytest.mark.parametrize("obs_cap", [3, 16])
def test_pack_sparse_matches_jax(obs_cap):
    kfs, pts = _fake_window()
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    fixed = [True] + [False] * (len(kfs) - 1)
    from visual_slam_tpu.backend.optimizer import LMOptimizer as JLMOptimizer
    from visual_slam_tpu.config import Config as JConfig

    outs = []
    for opt_cls, cfg in ((JLMOptimizer, JConfig()), (LMOptimizer, Config())):
        cfg.optimization.obs_cap = obs_cap
        kw = {} if opt_cls is JLMOptimizer else {"device": "cpu"}
        opt = opt_cls(cfg, SimpleNamespace(K=K), **kw)
        outs.append(opt._pack_sparse(kfs, pts, 8, 64, fixed))
    (pj, uj, sj, vj, kj, oj), (pt, ut, st, vt, kt, ot) = outs
    assert sj == st and uj == ut
    for a, b in ((vj, vt), (kj, kt), (oj, ot)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for name in ("obs_pose", "obs_valid", "pose_valid", "pose_fixed"):
        np.testing.assert_array_equal(getattr(pt, name), np.asarray(getattr(pj, name)))
    for name in ("T_w2c", "points", "uv"):
        np.testing.assert_array_equal(getattr(pt, name), np.asarray(getattr(pj, name)))
    if obs_cap == 3:
        assert (vt.sum(1) == 3).any()  # some tracks were cut to their subset


def test_compiled_slam_sparse_head_to_head():
    """Every solve in the sparse layout (``sparse_obs=True``) through the
    self-promoting ``CompiledSLAM`` of tests/test_torch_compiled_slam.py's
    17-frame world, the port from the JAX package's bootstrap map."""
    from test_torch_compiled_slam import (
        WORLDS, _ate, _camera, _configure, _port_from_map, _threads, small_config)
    from render import render_sequence
    from test_slam_e2e import small_config as jax_small_config
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu_torch import interop
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.state import State

    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(42), n_frames=17, step=0.3)
    jcfg = _configure(jax_small_config(), WORLDS["promotion"][1])
    jcfg.optimization.sparse_obs = True
    js = JCompiledSLAM(_camera(JCamera, frames, K), jcfg)
    i = 0
    while js.state.name != "OK":
        js.track([frames[i]], timestamp=i * 0.1)
        i += 1
    m = interop.map_from_numpy(js.map.get_keyframes(), js.map.get_map_points())
    T_boot = np.array(js.map.get_last_keyframe().T_w2c)
    start = i
    for k in range(i, len(frames)):
        js.track([frames[k]], timestamp=k * 0.1)
    js.shutdown()
    cfg = _configure(small_config(), WORLDS["promotion"][1])
    cfg.optimization.sparse_obs = True
    with _threads(2):
        slam = _port_from_map(m, cfg, _camera(PinholeCamera, frames, K), T_boot, (start - 1) * 0.1)
        sparse = []
        start0 = slam.optimizer.solve_start

        def solve_start(*a, **k):
            pending = start0(*a, **k)
            sparse.append(pending["sparse"])
            return pending

        slam.optimizer.solve_start = solve_start
        infos = [slam.track([frames[k]], timestamp=k * 0.1) for k in range(start, len(frames))]
        slam.shutdown()
    assert slam.state == State.OK, [x["state"] for x in infos]
    assert sparse and all(sparse)
    ate_j, ate_t = _ate(js, Ts_gt), _ate(slam, Ts_gt)
    assert ate_t < 0.45
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ate_t, ate_j)


@pytest.mark.cuda
def test_sparse_solve_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the solve's card path)")
    _, sparse = ba_world.make_problem(16, 4096, 16, track_len=16)
    sparse["pose_fixed"][:2] = True  # two gauge cameras: no free scale for rounding to wander along
    p = to_device(tba.BASparse(**sparse), "cpu")
    T_c, _, i_c = tba.bundle_adjust_robust_sparse(p, n_iter=10, n_iter2=10, huber=3.0 / 718.856)
    T_g, _, i_g = tba.bundle_adjust_robust_sparse(to_device(p, "cuda"), n_iter=10, n_iter2=10, huber=3.0 / 718.856)
    assert float(i_c["cost"]) < float(i_c["cost0"])
    np.testing.assert_allclose(float(i_g["cost"]), float(i_c["cost"]), rtol=1e-3)
    np.testing.assert_allclose(T_g.cpu().numpy(), T_c.numpy(), atol=1e-4)
