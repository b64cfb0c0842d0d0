"""Dense LM/Schur bundle adjustment and the optimizer facade of the torch
port against the JAX package on the CPU, on ``tests/test_ba.py``'s worlds.

Tolerances: one linear solve (``_solve_step``) within 1e-4 relative of the
step's norm; after the whole two-stage robust solve in float32, costs
within 1e-3 relative, poses within 1e-4 and points within 1e-3 (the LM
accept/reject sequence is the same, the rounding of each einsum is not);
the trimmed observation mask exactly. The mono gauge re-projection is host
numpy in both packages and agrees exactly in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from test_ba import make_ba_problem
from visual_slam_tpu.backend import ba as jba
from visual_slam_tpu.backend.optimizer import LMOptimizer as JLMOptimizer
from visual_slam_tpu_torch.backend import ba as tba
from visual_slam_tpu_torch.backend.optimizer import LMOptimizer
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.interop import ba_problem_from_numpy

torch.set_num_threads(1)

HUBER = 5.0 / 500.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _free(problem):
    return np.asarray(problem.pose_valid & ~problem.pose_fixed, np.float32)


def test_solve_step_matches_jax():
    problem, _, _, _ = make_ba_problem(np.random.default_rng(0), W=5, M=150)
    w = np.asarray(problem.obs_valid, np.float32)
    args = (problem.T_w2c, problem.points, problem.uv, jnp.asarray(w), jnp.asarray(_free(problem)))
    dxi_j, dX_j = jba._solve_step(*args, jnp.float32(1e-3), HUBER)
    dxi_t, dX_t = tba._solve_step(*[_t(a) for a in args], torch.tensor(1e-3), HUBER)
    dxi_j, dX_j = np.asarray(dxi_j), np.asarray(dX_j)
    assert np.isfinite(dxi_j).all() and np.abs(dxi_j).max() > 1e-3  # a real step
    np.testing.assert_allclose(dxi_t.numpy(), dxi_j, atol=1e-4 * np.abs(dxi_j).max())
    np.testing.assert_allclose(dX_t.numpy(), dX_j, atol=1e-4 * np.abs(dX_j).max())


@pytest.mark.parametrize("case", [
    dict(),  # one gauge camera, 0.3 px noise
    dict(noise_px=0.05, n_fixed=2, W=6, M=200),
    dict(outliers=12),  # gross outliers that the interim trim must drop
])
def test_bundle_adjust_robust_matches_jax(case):
    case = dict(case)
    n_out = case.pop("outliers", 0)
    rng = np.random.default_rng(1)
    problem, _, _, _ = make_ba_problem(rng, **case)
    if n_out:
        uv = np.array(problem.uv)
        rows = rng.choice(uv.shape[0], n_out, replace=False)
        uv[rows, 1] += 40.0 / 500.0  # 40 px off in the second camera
        problem = problem._replace(uv=jnp.asarray(uv))
    Tj, Xj, ij = jba.bundle_adjust_robust(problem, n_iter=8, n_iter2=8, huber=HUBER)
    Tt, Xt, it = tba.bundle_adjust_robust(ba_problem_from_numpy(problem), n_iter=8, n_iter2=8, huber=HUBER)
    c0, c = float(ij["cost0"]), float(ij["cost"])
    assert c < 0.5 * c0  # the cost falls in both
    np.testing.assert_allclose(float(it["cost0"]), c0, rtol=1e-5)
    np.testing.assert_allclose(float(it["cost"]), c, rtol=1e-3)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-3)
    np.testing.assert_array_equal(it["obs_kept"].numpy(), np.asarray(ij["obs_kept"]))
    assert int(it["n_trimmed"]) == int(ij["n_trimmed"]) >= n_out


def test_residuals_and_mean_error_match_jax():
    problem, _, _, _ = make_ba_problem(np.random.default_rng(2))
    p = ba_problem_from_numpy(problem)
    rn_j = np.asarray(jba.residual_norms(problem.T_w2c, problem.points, problem.uv, problem.obs_valid))
    rn_t = tba.residual_norms(p.T_w2c, p.points, p.uv, p.obs_valid).numpy()
    np.testing.assert_array_equal(np.isinf(rn_t), np.isinf(rn_j))
    fin = np.isfinite(rn_j)
    np.testing.assert_allclose(rn_t[fin], rn_j[fin], rtol=1e-5, atol=1e-9)
    e_j = float(jba.mean_reprojection_error(problem.T_w2c, problem.points, problem.uv, problem.obs_valid, 500.0))
    e_t = float(tba.mean_reprojection_error(p.T_w2c, p.points, p.uv, p.obs_valid, 500.0))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)


def test_non_positive_definite_step_is_rejected_in_both():
    """A negative damping makes the Schur system indefinite: JAX's Cholesky
    yields NaN, the port masks its ``cholesky_ex`` result to NaN on the
    device; in both the step is rejected (the cost stays at cost0) and the
    damping is clipped back up so the later iterations proceed."""
    problem, _, _, _ = make_ba_problem(np.random.default_rng(3))
    p = ba_problem_from_numpy(problem)
    w = np.asarray(problem.obs_valid, np.float32)
    dxi_j, _ = jba._solve_step(problem.T_w2c, problem.points, problem.uv, jnp.asarray(w),
                               jnp.asarray(_free(problem)), jnp.float32(-1e3), HUBER)
    dxi_t, dX_t = tba._solve_step(p.T_w2c, p.points, p.uv, _t(w), _t(_free(problem)), torch.tensor(-1e3), HUBER)
    assert np.isnan(np.asarray(dxi_j)).all()
    assert torch.isnan(dxi_t).all() and torch.isnan(dX_t).all()
    for info in (jba.bundle_adjust(problem, n_iter=6, huber=HUBER, lam0=-1e3)[2],
                 tba.bundle_adjust(p, n_iter=6, huber=HUBER, lam0=-1e3)[2]):
        costs = np.asarray(info["costs"])
        assert costs[0] == float(info["cost0"])  # the indefinite step was not taken
        assert np.isfinite(costs).all() and costs[-1] < 0.5 * float(info["cost0"])


def test_reimpose_mono_gauge_exact_float64():
    rng = np.random.default_rng(4)
    W, M = 5, 40
    T = np.tile(np.eye(4), (W, 1, 1))
    for j in range(W):
        T[j, :3, 3] = rng.normal(0, 1, 3)
    X = rng.normal(0, 3, (M, 3))
    kfs = [SimpleNamespace(t_c2w=rng.normal(0, 1, 3)) for _ in range(W)]
    fixed = [True, False, False, True, False]
    Tj, Tt = T.copy(), T.copy()
    Xj, gj = JLMOptimizer._reimpose_mono_gauge(Tj, X.copy(), kfs, fixed)
    Xt, gt = LMOptimizer._reimpose_mono_gauge(Tt, X.copy(), kfs, fixed)
    np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_array_equal(Xt, Xj)
    assert gt[0] == gj[0]
    np.testing.assert_array_equal(gt[1], gj[1])
    assert not np.array_equal(Tt, T)  # it moved the free poses


@pytest.mark.parametrize("sparse_obs,lm_minor,window,sparse", [
    (False, True, 8, False),
    (True, True, 8, True),  # the sparse rule comes first
    ("auto", True, 32, True),
    ("auto", True, 16, False),
    (False, "auto", 8, False),
    (False, False, 8, False),
])
def test_layout_dispatch_follows_jax(sparse_obs, lm_minor, window, sparse):
    """``LMOptimizer``'s layout rule is the JAX package's off the TPU: the
    sparse layout with ``sparse_obs=True``, or ``"auto"`` from
    ``sparse_auto_min_window`` = 32; otherwise the dense grid, whatever
    ``lm_minor`` says (the port's landmark-minor names are the dense
    solver)."""
    cfg = Config()
    cfg.optimization.sparse_obs, cfg.optimization.lm_minor = sparse_obs, lm_minor
    opt = LMOptimizer(cfg, SimpleNamespace(K=np.diag([300.0, 300.0, 1.0])), device="cpu")
    assert opt._use_sparse(window) is sparse
    assert tba.bundle_adjust_robust_lm is tba.bundle_adjust_robust and tba.bundle_adjust_lm is tba.bundle_adjust


def test_auto_layouts_resolve_to_dense():
    cfg = Config()
    cfg.optimization.sparse_obs = "auto"
    cfg.optimization.lm_minor = "auto"
    assert LMOptimizer(cfg, SimpleNamespace(K=np.eye(3)), device="cpu")._use_sparse(8) is False  # no raise
