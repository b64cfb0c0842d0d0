"""The JAX package's landmark-minor bundle adjustment (``bundle_adjust_lm``,
``bundle_adjust_robust_lm``; ``optimization.lm_minor=True``) against the
port, whose functions of those names are its dense solver, on the CPU, on
``tests/test_ba.py``'s problems.

Tolerances are ``tests/test_ba.py``'s for the two layouts (poses 2e-4,
points 2e-3, cost 1e-3 relative: the same math summed in another order);
one linear solve within 1e-4 of the step's size, as in
tests/test_torch_ba.py; the robust solve's trimmed count equal; fixed
poses untouched bit for bit.

End to end, the port's self-promoting ``CompiledSLAM`` with
``lm_minor=True`` from the JAX package's bootstrap map (the same JAX
configuration, landmark-minor, run to the end) solves every BA on the
dense grid and holds the JAX run's ATE band (max(1.5 x JAX's, JAX's +
0.05), the median of three rounding-neighbour runs, as
tests/test_torch_ba_sparse.py) and the JAX test's 0.45 gate.

The ``cuda`` case (skipped without a card) solves bench.py's problem
(``tests/ba_world.py``, W 10, M 4096, noise-free observations) with
``bundle_adjust_robust_lm`` on the card and on the CPU: both costs below
1e-6 of cost0, poses within 2e-4, points within 2e-3, the same trimmed
count. JAX is imported inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

import ba_world
from visual_slam_tpu_torch.backend import ba as tba
from visual_slam_tpu_torch.interop import ba_problem_from_numpy
from visual_slam_tpu_torch.utils.tree import to_device

torch.set_num_threads(1)

T_ATOL, X_ATOL, COST_RTOL = 2e-4, 2e-3, 1e-3


def _problem(seed, **kw):
    from test_ba import make_ba_problem

    return make_ba_problem(np.random.default_rng(seed), **kw)


def _robust_problem(seed):
    """test_ba.py's robust landmark-minor problem: a tenth of the landmarks
    up to 0.2 normalized units off in every camera."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    from test_ba import make_ba_problem

    problem, T_gt, pts_gt, f = make_ba_problem(rng, noise_px=0.2, n_fixed=2)
    uv = np.asarray(problem.uv).copy()
    n_bad = len(uv) // 10
    uv[:n_bad, :, :] += rng.uniform(-0.2, 0.2, (n_bad, uv.shape[1], 2))
    return problem._replace(uv=jnp.asarray(uv)), T_gt, pts_gt, f


def test_solve_step_lm_matches_jax():
    """JAX's landmark-minor linear solve against the port's dense one on the
    same inputs."""
    import jax.numpy as jnp

    from visual_slam_tpu.backend import ba as jba

    problem, _, _, f = _problem(0, W=5, M=150, n_fixed=2)
    p = ba_problem_from_numpy(problem)
    w = np.asarray(problem.obs_valid, np.float32)
    free = np.asarray(problem.pose_valid & ~problem.pose_fixed, np.float32)
    uv_lm = np.ascontiguousarray(np.transpose(np.asarray(problem.uv), (1, 2, 0)))
    dxi_j, dX_j = jba._solve_step_lm(problem.T_w2c, problem.points.T, jnp.asarray(uv_lm), jnp.asarray(w.T),
                                     jnp.asarray(free), jnp.float32(1e-3), 5.0 / f)
    dxi_t, dX_t = tba._solve_step(p.T_w2c, p.points, p.uv, torch.from_numpy(w), torch.from_numpy(free),
                                  torch.tensor(1e-3), 5.0 / f)
    dxi_j, dX_j = np.asarray(dxi_j), np.asarray(dX_j).T
    assert dX_t.shape == (150, 3) and np.isfinite(dxi_j).all() and np.abs(dxi_j).max() > 1e-3  # a real step
    np.testing.assert_allclose(dxi_t.numpy(), dxi_j, atol=1e-4 * np.abs(dxi_j).max())
    np.testing.assert_allclose(dX_t.numpy(), dX_j, atol=1e-4 * np.abs(dX_j).max())


def test_inv3x3_lm_is_the_landmark_major_inverse():
    """JAX's (3, 3, M) cofactor inverse against the port's (M, 3, 3) one."""
    import jax.numpy as jnp

    from visual_slam_tpu.backend import ba as jba

    rng = np.random.default_rng(5)
    B = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = np.einsum("mij,mkj->mik", B, B) + np.eye(3, dtype=np.float32)
    inv_j = np.transpose(np.asarray(jba._inv3x3_lm(jnp.asarray(np.transpose(A, (1, 2, 0))))), (2, 0, 1))
    inv_t = tba._inv3x3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-5, atol=1e-6 * np.abs(inv_j).max())
    np.testing.assert_allclose(np.einsum("mij,mjk->mik", A, inv_t), np.broadcast_to(np.eye(3), A.shape), atol=1e-4)


def test_bundle_adjust_lm_matches_jax_and_the_dense_layout():
    """test_ba.py's ``test_lm_minor_matches_reference_layout`` problem: the
    port against both of JAX's layouts."""
    from visual_slam_tpu.backend import ba as jba

    problem, _, _, f = _problem(0, W=5, M=150, n_fixed=2)
    p = ba_problem_from_numpy(problem)
    Tj, Xj, ij = jba.bundle_adjust_lm(problem, n_iter=15, huber=5.0 / f)
    Td, Xd, idn = jba.bundle_adjust(problem, n_iter=15, huber=5.0 / f)
    Tl, Xl, il = tba.bundle_adjust_lm(p, n_iter=15, huber=5.0 / f)
    assert Xl.shape == (150, 3) and float(il["cost"]) < 0.5 * float(il["cost0"])
    for T, X, info in ((Tj, Xj, ij), (Td, Xd, idn)):
        T, X = np.asarray(T), np.asarray(X)
        np.testing.assert_allclose(Tl.numpy(), T, atol=T_ATOL)
        np.testing.assert_allclose(Xl.numpy(), X, atol=X_ATOL)
        np.testing.assert_allclose(float(il["cost"]), float(info["cost"]), rtol=COST_RTOL)
        np.testing.assert_allclose(float(il["cost0"]), float(info["cost0"]), rtol=1e-5)
    assert il["costs"].shape == (15,)


def test_bundle_adjust_robust_lm_matches_jax_and_the_dense_layout():
    """test_ba.py's ``test_lm_minor_robust_matches_reference_layout``
    problem: the trim drops the same count of observations in the port and
    both of JAX's layouts, and the translations land within 3e-2 of the
    truth."""
    from visual_slam_tpu.backend import ba as jba

    problem, T_gt, _, f = _robust_problem(0)
    p = ba_problem_from_numpy(problem)
    kw = dict(n_iter=12, n_iter2=12, huber=3.0 / f)
    Tj, Xj, ij = jba.bundle_adjust_robust_lm(problem, **kw)
    Td, Xd, idn = jba.bundle_adjust_robust(problem, **kw)
    Tl, Xl, il = tba.bundle_adjust_robust_lm(p, **kw)
    assert int(il["n_trimmed"]) == int(ij["n_trimmed"]) == int(idn["n_trimmed"]) > 0
    np.testing.assert_array_equal(il["obs_kept"].numpy(), np.asarray(ij["obs_kept"]))
    np.testing.assert_allclose(Tl.numpy()[:, :3, 3], T_gt[:, :3, 3], atol=3e-2)
    for T, X, info in ((Tj, Xj, ij), (Td, Xd, idn)):
        T, X = np.asarray(T), np.asarray(X)
        np.testing.assert_allclose(Tl.numpy(), T, atol=T_ATOL)
        np.testing.assert_allclose(Xl.numpy(), X, atol=X_ATOL)
        np.testing.assert_allclose(float(il["cost"]), float(info["cost"]), rtol=COST_RTOL)


@pytest.mark.parametrize("robust", [False, True])
def test_lm_minor_fixed_poses_untouched(robust):
    problem, _, _, f = _problem(0, n_fixed=2)
    p = ba_problem_from_numpy(problem)
    T0 = p.T_w2c.clone()
    if robust:
        T, _, _ = tba.bundle_adjust_robust_lm(p, n_iter=5, n_iter2=5, huber=5.0 / f)
    else:
        T, _, _ = tba.bundle_adjust_lm(p, n_iter=10, huber=5.0 / f)
    np.testing.assert_array_equal(T[:2].numpy(), T0[:2].numpy())
    assert not torch.equal(T[2:], T0[2:])


def test_residual_norms_lm_match_jax():
    """JAX's landmark-minor residual pass (the robust solve's interim trim)
    against the port's ``residual_norms``."""
    import jax.numpy as jnp

    from visual_slam_tpu.backend import ba as jba

    problem, _, _, _ = _problem(2)
    p = ba_problem_from_numpy(problem)
    r, _, _, in_front = jba._residuals_and_jacobians_lm(problem.T_w2c, problem.points.T,
                                                        jnp.transpose(problem.uv, (1, 2, 0)), problem.obs_valid.T)
    rn_j = np.where(np.asarray(problem.obs_valid) & np.asarray(in_front).T,
                    np.sqrt(np.sum(np.asarray(r) ** 2, axis=1)).T, np.inf)
    rn_t = tba.residual_norms(p.T_w2c, p.points, p.uv, p.obs_valid).numpy()
    np.testing.assert_array_equal(np.isinf(rn_t), np.isinf(rn_j))
    fin = np.isfinite(rn_j)
    np.testing.assert_allclose(rn_t[fin], rn_j[fin], rtol=1e-5, atol=1e-9)


def test_non_positive_definite_lm_step_is_rejected():
    """A negative damping makes the Schur system indefinite: the step is
    NaN on the device and rejected, and the damping recovers, as in the
    landmark-major solver and JAX."""
    from visual_slam_tpu.backend import ba as jba

    problem, _, _, _ = _problem(3)
    p = ba_problem_from_numpy(problem)
    for info in (jba.bundle_adjust_lm(problem, n_iter=6, huber=5.0 / 500.0, lam0=-1e3)[2],
                 tba.bundle_adjust_lm(p, n_iter=6, huber=5.0 / 500.0, lam0=-1e3)[2]):
        costs = np.asarray(info["costs"])
        assert costs[0] == float(info["cost0"])
        assert np.isfinite(costs).all() and costs[-1] < 0.5 * float(info["cost0"])


def test_compiled_slam_lm_minor_holds_the_jax_band():
    """The self-promoting world of tests/test_torch_compiled_slam.py with
    ``lm_minor=True`` in both packages, the port from JAX's bootstrap map:
    the configuration accepted, every solve on the dense grid, the ATE in
    the band of JAX's landmark-minor run."""
    from render import render_sequence
    from test_torch_compiled_slam import WORLDS, _ate, _camera, _configure, _port_from_map, _threads, small_config
    from test_slam_e2e import small_config as jax_small_config
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.models import CompiledSLAM as JCompiledSLAM
    from visual_slam_tpu_torch import interop
    from visual_slam_tpu_torch.backend import optimizer as topt
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.state import State

    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(42), n_frames=17, step=0.3)
    jcfg = _configure(jax_small_config(), WORLDS["promotion"][1])
    jcfg.optimization.lm_minor = True
    js = JCompiledSLAM(_camera(JCamera, frames, K), jcfg)
    i = 0
    while js.state.name != "OK":
        js.track([frames[i]], timestamp=i * 0.1)
        i += 1
    scales = (1.0, 1.0 + 1e-6, 1.0 - 1e-6)
    maps = [interop.map_from_numpy(js.map.get_keyframes(), js.map.get_map_points()) for _ in scales]
    T_boot = np.array(js.map.get_last_keyframe().T_w2c)
    start = i
    for k in range(i, len(frames)):
        js.track([frames[k]], timestamp=k * 0.1)
    js.shutdown()
    solved = []
    dense0 = topt.bundle_adjust_robust

    def dense(*a, **kw):
        solved.append("dense")
        return dense0(*a, **kw)

    def sparse(*a, **kw):
        raise AssertionError("a solve took the sparse layout")

    ates = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(topt, "bundle_adjust_robust", dense)
        mp.setattr(topt, "bundle_adjust_robust_sparse", sparse)
        for m, scale in zip(maps, scales):
            cfg = _configure(small_config(), WORLDS["promotion"][1])
            cfg.optimization.lm_minor = True
            with _threads(2):
                slam = _port_from_map(m, cfg, _camera(PinholeCamera, frames, K), T_boot, (start - 1) * 0.1)
                infos = [slam.track([frames[k] * np.float32(scale)], timestamp=k * 0.1)
                         for k in range(start, len(frames))]
                slam.shutdown()
            assert slam.state == State.OK, (scale, [x["state"] for x in infos])
            ates.append(_ate(slam, Ts_gt))
    assert len(solved) >= len(scales)
    ate_j, ate_t = _ate(js, Ts_gt), float(np.median(ates))
    assert ate_t < 0.45, ates
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ates, ate_j)


@pytest.mark.cuda
def test_lm_minor_solve_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the solve's card path)")
    p = to_device(tba.BAProblem(**ba_world.bench_problem()), "cpu")
    kw = dict(n_iter=10, n_iter2=10, huber=5.0 / 718.856)
    T_c, X_c, i_c = tba.bundle_adjust_robust_lm(p, **kw)
    T_g, X_g, i_g = tba.bundle_adjust_robust_lm(to_device(p, "cuda"), **kw)
    # Noise-free observations: both solves end at the float32 floor of the
    # cost, where its relative rounding is no measure; the poses and points are.
    for info in (i_c, i_g):
        assert float(info["cost"]) < 1e-6 * float(info["cost0"])
    np.testing.assert_allclose(T_g.cpu().numpy(), T_c.numpy(), atol=T_ATOL)
    np.testing.assert_allclose(X_g.cpu().numpy(), X_c.numpy(), atol=X_ATOL)
    assert int(i_g["n_trimmed"]) == int(i_c["n_trimmed"])
