"""The pose graph's Lie functions in the torch port against the JAX package:
values at random, near-zero and near-pi rotations, and the forward-mode
Jacobian at the identity, where every odometry edge of a pose graph sits
at its first iteration. Tolerance: atol 1e-5 on values (f32, different
operation order), 1e-4 on Jacobians."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)

ATOL = 1e-5


def _rotvecs(rng, n=60):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    unit = w / np.linalg.norm(w, axis=1, keepdims=True)
    w[:15] *= 1e-7  # near zero: the Taylor guards
    w[15:30] = unit[15:30] * np.float32(np.pi - 1e-3)  # near pi: the quaternion route
    w[30:35] = 0.0
    return w


def test_so3_log_and_quaternions_match_jax():
    rng = np.random.default_rng(20)
    w = _rotvecs(rng)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    q_j = np.array(jlie.rotmat_to_quat(jnp.asarray(R)))
    q_t = tlie.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=ATOL)
    np.testing.assert_allclose(
        tlie.quat_to_rotvec(torch.from_numpy(q_j)).numpy(), np.asarray(jlie.quat_to_rotvec(jnp.asarray(q_j))), atol=ATOL
    )
    log_t = tlie.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(log_t, np.asarray(jlie.so3_log(jnp.asarray(R))), atol=ATOL)
    np.testing.assert_allclose(log_t[35:], w[35:], atol=1e-4)  # a round trip away from pi


def test_se3_exp_log_inv_match_jax():
    rng = np.random.default_rng(21)
    xi = np.concatenate([rng.normal(0, 2, (60, 3)).astype(np.float32), _rotvecs(rng)], axis=1)
    T_j = np.array(jlie.se3_exp(jnp.asarray(xi)))
    T_t = tlie.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=ATOL)
    np.testing.assert_allclose(
        tlie.se3_log(torch.from_numpy(T_j)).numpy(), np.asarray(jlie.se3_log(jnp.asarray(T_j))), atol=1e-4
    )
    np.testing.assert_allclose(tlie.inv_T(torch.from_numpy(T_j)).numpy(), np.asarray(jlie.inv_T(jnp.asarray(T_j))), atol=ATOL)


@pytest.mark.parametrize("offset", [0.0, 1e-9, 1e-4])
def test_log_exp_jacobian_near_identity_matches_jax(offset):
    """jacfwd of r(xi) = se3_log(inv(T_meas) exp(xi) T) at xi = 0 with
    T_meas = T (offset 0: exactly the identity inside the log) or a small
    rotation away: finite, and equal to JAX's jax.jacfwd within 1e-4."""
    rng = np.random.default_rng(22)
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.5, (4, 6)).astype(np.float32))))
    dT = np.asarray(jlie.se3_exp(jnp.asarray(np.full((4, 6), offset, np.float32))))
    T_meas = np.einsum("nij,njk->nik", T, np.linalg.inv(dT)).astype(np.float32)

    def f_j(x):
        return jlie.se3_log(jlie.inv_T(jnp.asarray(T_meas)) @ jlie.se3_exp(x.reshape(4, 6)) @ jnp.asarray(T)).reshape(-1)

    def f_t(x):
        return tlie.se3_log(tlie.inv_T(torch.from_numpy(T_meas)) @ tlie.se3_exp(x.reshape(4, 6)) @ torch.from_numpy(T)).reshape(-1)

    J_j = np.asarray(jax.jacfwd(f_j)(jnp.zeros(24)))
    J_t = torch.func.jacfwd(f_t)(torch.zeros(24)).numpy()
    assert np.isfinite(J_t).all()
    np.testing.assert_allclose(J_t, J_j, atol=1e-4)


def test_det3x3_matches_jax():
    """The closed-form determinant against JAX's and numpy's
    (tests/test_lie.py's rtol 2e-4), batched and unbatched."""
    rng = np.random.default_rng(7)
    A = rng.normal(0, 2, (32, 3, 3)).astype(np.float32)
    det_t = tlie.det3x3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(det_t, np.asarray(jlie.det3x3(jnp.asarray(A))), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(det_t, np.linalg.det(A), rtol=2e-4, atol=1e-5)
    assert abs(float(tlie.det3x3(torch.from_numpy(A[0]))) - float(np.linalg.det(A[0]))) < 2e-4 * abs(float(np.linalg.det(A[0])))


def test_project_to_so3_newton_matches_jax_and_svd():
    """Newton's polar iteration on noisy near-rotations (the DLT-fit
    regime) against JAX's and against the SVD projection (tests/test_lie.py's
    5e-5); proper rotations. ``project_to_so3`` on CPU tensors stays the
    SVD route."""
    rng = np.random.default_rng(24)
    Ms = []
    for i in range(24):
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1, 3).astype(np.float32))))
        Ms.append(rng.uniform(0.3, 3.0) * R + rng.normal(0, 0.05 * (i % 4), (3, 3)))
    M = np.stack(Ms).astype(np.float32)
    R_new = tlie.project_to_so3_newton(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(R_new, np.asarray(jlie.project_to_so3_newton(jnp.asarray(M))), atol=1e-5)
    R_svd = tlie.project_to_so3(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(R_new, R_svd, atol=5e-5)
    np.testing.assert_allclose(R_svd, np.asarray(jax.vmap(jlie.project_to_so3)(jnp.asarray(M))), atol=5e-5)
    np.testing.assert_allclose(np.einsum("nij,nik->njk", R_new, R_new), np.tile(np.eye(3), (24, 1, 1)), atol=5e-5)
    assert np.all(np.linalg.det(R_new) > 0.99)
