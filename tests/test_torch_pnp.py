"""PnP of the torch port against the JAX package: DLT, Gauss-Newton,
reprojection error, and RANSAC fed the JAX sampler's minimal sets.
Geometry tolerance: atol 1e-4 (f32, different summation orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops import linalg as jlinalg
from visual_slam_tpu.ops import pnp as jpnp
from visual_slam_tpu_torch.ops import epipolar as tepi
from visual_slam_tpu_torch.ops import linalg as tlinalg
from visual_slam_tpu_torch.ops import pnp as tpnp

torch.set_num_threads(1)

ATOL = 1e-4
DLT_T_ATOL = 5e-4  # translation of a lone f32 DLT fit, see test_pnp_dlt_matches_jax


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    """200 correspondences in normalized coordinates: 70% inliers with
    0.5 px noise at f=500, 30% outliers."""
    rng = np.random.default_rng(7)
    N = 200
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t = np.array([0.2, -0.05, 0.3], np.float32)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(5, 25, N)], 1).astype(np.float32)
    pc = X @ R.T + t
    xy = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5 / 500, (N, 2))).astype(np.float32)
    out = rng.random(N) < 0.3
    xy[out] = rng.uniform(-0.6, 0.6, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    return R, t, X, xy, mask, out


def test_nullspace_vector_matches_jax_eigh():
    rng = np.random.default_rng(8)
    A = rng.normal(0, 1, (16, 20, 12)).astype(np.float32)
    AtA = np.einsum("bni,bnj->bij", A, A)
    v_j = np.asarray(jlinalg.nullspace_vector(jnp.asarray(AtA)))
    v_t = tlinalg.nullspace_vector(_t(AtA)).numpy()
    sign = np.sign(np.sum(v_j * v_t, axis=-1, keepdims=True))  # eigenvectors up to sign
    np.testing.assert_allclose(v_t * sign, v_j, atol=ATOL)


def test_pnp_dlt_matches_jax(scene):
    """40 points of a unit-scale scene; R within 1e-4 of the JAX function.
    The DLT's 12x12 normal matrix is unnormalized, and f32 rounding in it
    moves the nullvector in either package: on the 5-25 m scene by ~1e-3,
    here by up to ~1.4e-4 in t (the nullvector's last column over the
    scale). So t is held to 5e-4, and RANSAC's polished pose below to 1e-4.
    The batched call (RANSAC's layout) equals the one-by-one calls."""
    R, t = scene[0], scene[1]
    rng = np.random.default_rng(10)
    X = np.stack([rng.uniform(-1, 1, (4, 40)), rng.uniform(-1, 1, (4, 40)), rng.uniform(2, 4, (4, 40))], -1).astype(np.float32)
    pc = X @ R.T + t
    xy = (pc[..., :2] / pc[..., 2:3] + rng.normal(0, 1e-3, pc[..., :2].shape)).astype(np.float32)
    w = np.ones((4, 40), np.float32)
    R_b, t_b = tpnp.pnp_dlt(_t(X), _t(xy), _t(w))
    for b in range(4):
        R_j, t_j = jpnp.pnp_dlt(jnp.asarray(X[b]), jnp.asarray(xy[b]), jnp.asarray(w[b]))
        R_t, t_t = tpnp.pnp_dlt(_t(X[b]), _t(xy[b]), _t(w[b]))
        np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=ATOL)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=DLT_T_ATOL)
        np.testing.assert_allclose(R_b[b].numpy(), R_t.numpy(), atol=1e-6)
        np.testing.assert_allclose(t_b[b].numpy(), t_t.numpy(), atol=1e-6)
        np.testing.assert_allclose(R_t.numpy(), R, atol=0.01)


def test_refine_and_reproj_match_jax(scene):
    R, t, X, xy, mask, out = scene
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.07, -0.12, 0.0], jnp.float32)))
    t0 = t + np.array([0.05, 0.02, -0.1], np.float32)
    w = (~out).astype(np.float32)
    R_j, t_j = jpnp.refine_pose_gn(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), jnp.asarray(xy), jnp.asarray(w), iters=8, huber=6e-3)
    R_t, t_t = tpnp.refine_pose_gn(_t(R0), _t(t0), _t(X), _t(xy), _t(w), iters=8, huber=6e-3)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=ATOL)
    e_j = np.asarray(jpnp._reproj_err2(R_j, t_j, jnp.asarray(X), jnp.asarray(xy)))
    e_t = tpnp._reproj_err2(R_t, t_t, _t(X), _t(xy)).numpy()
    np.testing.assert_allclose(e_t, e_j, atol=ATOL)


def test_ransac_pnp_with_injected_samples_matches_jax(scene):
    """Torch cannot reproduce JAX's random bits: the port's RANSAC takes
    the JAX sampler's (n_hyp, 6) draws instead of its own."""
    R, t, X, xy, mask, out = scene
    key = jax.random.PRNGKey(3)
    thresh = 3.0 / 500.0
    ref = jpnp.ransac_pnp(jnp.asarray(X), jnp.asarray(xy), jnp.asarray(mask), key, n_hyp=64, thresh=thresh)
    idx = np.asarray(jepi._sample_minimal_sets(key, jnp.asarray(mask), 64, 6))
    got = tpnp.ransac_pnp(_t(X), _t(xy), _t(mask), n_hyp=64, thresh=torch.tensor(thresh), sample_idx=_t(idx))
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=ATOL)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=ATOL)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
    assert int(got["n_inliers"]) == int(ref["n_inliers"])
    np.testing.assert_allclose(got["R"].numpy(), R, atol=0.01)


def test_sample_minimal_sets_draws_from_mask():
    """The port's own sampler: every draw is a masked-in entry, the draws
    are deterministic per seed and cover the mask roughly uniformly."""
    rng = np.random.default_rng(9)
    mask = torch.from_numpy(rng.random(300) > 0.6)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tepi._sample_minimal_sets(g1, mask, 2000, 6)
    b = tepi._sample_minimal_sets(g2, mask, 2000, 6)
    assert a.shape == (2000, 6) and torch.equal(a, b)
    assert mask[a].all()
    counts = torch.bincount(a.reshape(-1), minlength=300)[mask].double()
    expected = 12000 / int(mask.sum())
    assert (counts - expected).abs().max() < 6 * expected**0.5
