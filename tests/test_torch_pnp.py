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
from visual_slam_tpu_torch.ops import lie as tlie
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


# ---------------------------------------------------------------------------
# The CUDA route of pnp_dlt (nullspace_vector's direct method and the closed
# forms of _dlt_pose_closed), run on CPU tensors, against JAX's pnp_dlt with
# its accelerator nullspace (smallest_eigvec_psd) patched in. JAX keeps its
# SVDs on every backend, so the pose stage is held to JAX's SVD pose from
# the same projection matrix, and the whole route where the fit is well
# conditioned. A lone minimal-sample DLT is f32-chaotic in either package:
# 4 inverse iterations leave its nullvector unconverged where the Gram's two
# smallest eigenvalues are close, so two packages' vectors agree to 1.5e-3
# in alignment only.


def _jax_accel_fit(monkeypatch):
    """JAX's pnp_dlt over a batch with ``smallest_eigvec_psd`` as its
    nullspace, returning (R, t, the nullvector)."""
    got = []

    def nullspace(AtA):
        got.append(jlinalg.smallest_eigvec_psd(AtA))
        return got[-1]

    monkeypatch.setattr(jpnp, "nullspace_vector", nullspace)
    return jax.jit(jax.vmap(lambda X, xy, w: (*jpnp.pnp_dlt(X, xy, w), got[-1])))


def _closed_route(monkeypatch):
    monkeypatch.setattr(tpnp, "nullspace_vector", tlinalg.smallest_eigvec_psd)
    monkeypatch.setattr(tpnp, "_dlt_pose", tpnp._dlt_pose_closed)


def _unflipped(M, p4, X):
    """Which fits the cheirality test flips (weighted mean depth < 0 with
    unit weights), from the scaled Newton projection."""
    det = np.linalg.det(M)
    scale = np.abs(det) ** (1 / 3) * np.sign(det)
    R = tlie.project_to_so3_newton(torch.from_numpy((M / scale[:, None, None]).astype(np.float32))).numpy()
    z = np.einsum("hnk,hk->hn", X, R[:, 2]) + (p4[:, 2] / scale)[:, None]
    return z.sum(-1) >= 0


@pytest.mark.parametrize("sample", ["consistent", "outlier_mixed"])
def test_pnp_dlt_closed_route_matches_jax(scene, sample, monkeypatch):
    """Minimal samples as RANSAC draws them (6 points, 128 hypotheses):
    from the scene's inliers only, or from every masked point (30 %
    outliers). The nullvectors align with JAX's to 1.5e-3 (1e-5 at the
    median); from JAX's own nullvector, the closed forms give JAX's SVD pose
    on every unflipped fit (R atol 2e-5, t rtol 1e-4) and JAX's t on a
    flipped one, with a proper rotation (det > 0.99, R^T R = I) whose
    weighted depth is positive."""
    R, t, X, xy, mask, out = scene
    rng = np.random.default_rng(11)
    pool = np.nonzero(mask & ~out)[0] if sample == "consistent" else np.nonzero(mask)[0]
    idx = np.stack([rng.choice(pool, 6, replace=False) for _ in range(128)])
    Xs, xs, w = X[idx], xy[idx], np.ones((128, 6), np.float32)
    R_j, t_j, p_j = (np.asarray(a) for a in _jax_accel_fit(monkeypatch)(jnp.asarray(Xs), jnp.asarray(xs), jnp.asarray(w)))
    _closed_route(monkeypatch)
    seen = []
    monkeypatch.setattr(tpnp, "nullspace_vector", lambda AtA: seen.append(tlinalg.smallest_eigvec_psd(AtA)) or seen[-1])
    tpnp.pnp_dlt(_t(Xs), _t(xs), _t(w))
    align = np.abs(np.sum(seen[-1].numpy() * p_j, axis=-1))
    assert align.min() > 1 - 1.5e-3 and np.median(align) > 1 - 1e-5, (align.min(), np.median(align))
    monkeypatch.setattr(tpnp, "nullspace_vector", lambda AtA: _t(p_j))
    R_c, t_c = (a.numpy() for a in tpnp.pnp_dlt(_t(Xs), _t(xs), _t(w)))
    P = p_j.reshape(-1, 3, 4)
    keep = _unflipped(P[..., :3], P[..., 3], Xs)
    assert keep.sum() >= (100 if sample == "consistent" else 20)
    np.testing.assert_allclose(R_c[keep], R_j[keep], atol=2e-5)
    np.testing.assert_allclose(t_c, t_j, rtol=1e-4, atol=1e-6)
    assert np.all(np.linalg.det(R_c) > 0.99)
    np.testing.assert_allclose(np.einsum("hji,hjk->hik", R_c, R_c), np.tile(np.eye(3), (128, 1, 1)), atol=1e-4)
    z = np.einsum("hnk,hk->hn", Xs, R_c[:, 2]) + t_c[:, 2:3]
    assert np.all(z.sum(-1)[~keep] > 0)


def test_pnp_dlt_closed_route_flip_branch_is_a_proper_rotation(scene, monkeypatch):
    """Points behind the camera: the fit's rotation has det 1 and its
    weighted depth is negative, so both routes flip. JAX's SVD returns one
    of the rotations nearest to -R (all three singular values are 1); the
    closed route returns diag(1, -1, -1) R: proper (det > 0.99, R^T R = I
    to 1e-5), the depths positive, t = JAX's within 5e-4 (DLT_T_ATOL)."""
    R, t = scene[0], scene[1]
    rng = np.random.default_rng(12)
    X = np.stack([rng.uniform(-1, 1, (4, 40)), rng.uniform(-1, 1, (4, 40)), rng.uniform(-4, -2, (4, 40))], -1)
    X = X.astype(np.float32)
    pc = X @ R.T + t
    xy = (pc[..., :2] / pc[..., 2:3] + rng.normal(0, 1e-4, pc[..., :2].shape)).astype(np.float32)
    w = np.ones((4, 40), np.float32)
    R_j, t_j, _ = (np.asarray(a) for a in _jax_accel_fit(monkeypatch)(jnp.asarray(X), jnp.asarray(xy), jnp.asarray(w)))
    _closed_route(monkeypatch)
    R_c, t_c = (a.numpy() for a in tpnp.pnp_dlt(_t(X), _t(xy), _t(w)))
    assert np.all(np.linalg.det(R_c) > 0.99) and np.all(np.linalg.det(R_j) > 0.99)
    np.testing.assert_allclose(np.einsum("hji,hjk->hik", R_c, R_c), np.tile(np.eye(3), (4, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(t_c, t_j, atol=DLT_T_ATOL)
    np.testing.assert_allclose(t_c, -t[None].repeat(4, 0), atol=0.01)  # flipped: -t
    np.testing.assert_allclose(R_c[:, 2], -R[None, 2].repeat(4, 0), atol=0.01)  # the third row of -R
    assert np.all(np.einsum("hnk,hk->hn", X, R_c[:, 2]).sum(-1) + 40 * t_c[:, 2] > 0)


def test_pnp_dlt_closed_route_on_well_conditioned_fits_matches_jax(scene, monkeypatch):
    """The whole route where the fit is well conditioned: the 40-point fits
    of test_pnp_dlt_matches_jax (R atol 1e-4, t DLT_T_ATOL) and the refit
    over the scene's ~130 inliers (R and t atol 1e-4), against JAX's
    accelerator route."""
    R, t, X, xy, mask, out = scene
    rng = np.random.default_rng(10)
    Xb = np.stack([rng.uniform(-1, 1, (4, 40)), rng.uniform(-1, 1, (4, 40)), rng.uniform(2, 4, (4, 40))], -1)
    Xb = Xb.astype(np.float32)
    pc = Xb @ R.T + t
    xyb = (pc[..., :2] / pc[..., 2:3] + rng.normal(0, 1e-3, pc[..., :2].shape)).astype(np.float32)
    wb = np.ones((4, 40), np.float32)
    w1 = (mask & ~out).astype(np.float32)[None]
    fit = _jax_accel_fit(monkeypatch)
    R_j, t_j, _ = (np.asarray(a) for a in fit(jnp.asarray(Xb), jnp.asarray(xyb), jnp.asarray(wb)))
    R_j1, t_j1, _ = (np.asarray(a) for a in fit(jnp.asarray(X[None]), jnp.asarray(xy[None]), jnp.asarray(w1)))
    _closed_route(monkeypatch)
    R_c, t_c = (a.numpy() for a in tpnp.pnp_dlt(_t(Xb), _t(xyb), _t(wb)))
    np.testing.assert_allclose(R_c, R_j, atol=ATOL)
    np.testing.assert_allclose(t_c, t_j, atol=DLT_T_ATOL)
    R_c1, t_c1 = (a.numpy() for a in tpnp.pnp_dlt(_t(X[None]), _t(xy[None]), _t(w1)))
    np.testing.assert_allclose(R_c1, R_j1, atol=ATOL)
    np.testing.assert_allclose(t_c1, t_j1, atol=ATOL)
    np.testing.assert_allclose(R_c1[0], R, atol=0.01)


def test_ransac_pnp_closed_route_matches_jax_accelerator_route(scene, monkeypatch):
    """RANSAC's winner on the seeded scene with the JAX sampler's draws:
    the port's CUDA route on CPU tensors against JAX's ransac_pnp with its
    accelerator nullspace (run unjitted, so no compiled program keeps the
    patch): R and t within 1e-4, the same inliers."""
    R, t, X, xy, mask, out = scene
    key = jax.random.PRNGKey(3)
    thresh = 3.0 / 500.0
    monkeypatch.setattr(jpnp, "nullspace_vector", jlinalg.smallest_eigvec_psd)
    ref = jpnp.ransac_pnp.__wrapped__(jnp.asarray(X), jnp.asarray(xy), jnp.asarray(mask), key, n_hyp=64, thresh=thresh)
    idx = np.asarray(jepi._sample_minimal_sets(key, jnp.asarray(mask), 64, 6))
    _closed_route(monkeypatch)
    got = tpnp.ransac_pnp(_t(X), _t(xy), _t(mask), n_hyp=64, thresh=torch.tensor(thresh), sample_idx=_t(idx))
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=ATOL)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=ATOL)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_allclose(got["R"].numpy(), R, atol=0.01)
