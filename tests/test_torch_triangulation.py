"""Triangulation of the torch port against the JAX package on the CPU:
triangulate_dlt, the gated boundary chain triangulate_gated, depth and
parallax gates, masked_median (even and odd counts) and
median_ray_parallax. Points: atol 1e-4 relative to the scene's 5-25 m
depths (f32 eigh in different operation orders); gates exact where no
value sits on a threshold; medians exact (a sort and one mean)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops import triangulation as jtri
from visual_slam_tpu_torch.ops import triangulation as ttri

torch.set_num_threads(1)

F = 500.0
K = np.array([[F, 0, 320], [0, F, 240], [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def two_views():
    """150 points seen by two cameras 1 m apart with a small rotation;
    0.3 px noise, a tenth of the pairs swapped to bad matches."""
    rng = np.random.default_rng(11)
    N = 150
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(5, 25, N)], 1).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.03, 0.005], jnp.float32)))
    T2[:3, 3] = -T2[:3, :3] @ np.array([1.0, 0.05, 0.1], np.float32)

    def project(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * F + K[:2, 2]
        return (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)

    uv1, uv2 = project(T1), project(T2)
    bad = rng.choice(N, N // 10, replace=False)
    uv2[bad] = uv2[np.roll(bad, 1)]
    return T1, T2, uv1, uv2


def test_triangulate_dlt_matches_jax(two_views):
    T1, T2, uv1, uv2 = two_views
    Kinv = np.linalg.inv(K)
    x1 = (np.c_[uv1, np.ones(len(uv1))] @ Kinv.T)[:, :2].astype(np.float32)
    x2 = (np.c_[uv2, np.ones(len(uv2))] @ Kinv.T)[:, :2].astype(np.float32)
    pj, okj = jtri.triangulate_dlt(jnp.asarray(T1[:3]), jnp.asarray(T2[:3]), jnp.asarray(x1), jnp.asarray(x2))
    pt, okt = ttri.triangulate_dlt(_t(T1[:3]), _t(T2[:3]), _t(x1), _t(x2))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    good = np.asarray(okj)
    # Relative to depth: the DLT of a bad match can land far away.
    depth = np.maximum(np.abs(np.asarray(pj)[:, 2:3]), 1.0)
    np.testing.assert_allclose(pt.numpy()[good] / depth[good], np.asarray(pj)[good] / depth[good], atol=1e-4)


def test_triangulate_dlt_batched_cameras_match_per_camera(two_views):
    """The port's batch of second cameras (recover_pose's four candidates,
    which the JAX version ``vmap``s) equals one call per camera."""
    T1, T2, uv1, uv2 = two_views
    x1, x2 = _t(uv1 / F), _t(uv2 / F)
    P2 = torch.stack([_t(T2[:3]), _t(T1[:3]) + 0.1, _t(T2[:3]) * -1.0])
    pb, okb = ttri.triangulate_dlt(_t(T1[:3]), P2, x1, x2)
    for c in range(3):
        pc, okc = ttri.triangulate_dlt(_t(T1[:3]), P2[c], x1, x2)
        torch.testing.assert_close(pb[c], pc, rtol=1e-5, atol=1e-4)
        assert torch.equal(okb[c], okc)


def test_triangulate_gated_matches_jax(two_views):
    T1, T2, uv1, uv2 = two_views
    args_np = (np.linalg.inv(K).astype(np.float32), T1, T2, uv1, uv2)
    gates = (np.float32(0.1), np.float32(50.0), np.float32(np.deg2rad(0.5)), np.float32(3.0 / F))
    pj, gj = jtri.triangulate_gated(*[jnp.asarray(a) for a in args_np], *gates)
    pt, gt = ttri.triangulate_gated(*[_t(a) for a in args_np], *[torch.tensor(g) for g in gates])
    gj = np.asarray(gj)
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert 0.6 * len(gj) < gj.sum() < len(gj)  # the bad matches are gated out
    np.testing.assert_allclose(pt.numpy()[gj], np.asarray(pj)[gj], atol=1e-3, rtol=1e-4)


def test_depth_and_parallax_gates_match_jax(two_views):
    T1, T2, uv1, _ = two_views
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200), rng.uniform(-5, 60, 200)], 1).astype(np.float32)
    for a, b in ((T1, T2), (T2, T1)):
        dj = jtri.depth_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(X), 0.1, 50.0)
        dt = ttri.depth_mask(_t(a), _t(b), _t(X), 0.1, 50.0)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        pj = jtri.parallax_angles(jnp.asarray(a), jnp.asarray(b), jnp.asarray(X))
        pt = ttri.parallax_angles(_t(a), _t(b), _t(X))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 8, 64])
def test_masked_median_matches_jax(n_valid):
    """Even counts average the two middle values (torch.median would
    return the lower one); odd counts take the middle; none gives 0."""
    rng = np.random.default_rng(n_valid)
    x = rng.normal(0, 1, (3, 64)).astype(np.float32)
    mask = np.zeros((3, 64), bool)
    for r in range(3):
        mask[r, rng.choice(64, n_valid, replace=False)] = True
    mj = np.asarray(jtri.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    mt = ttri.masked_median(_t(x), _t(mask)).numpy()
    np.testing.assert_array_equal(mt, mj)
    if n_valid == 2:
        assert mt[0] == np.float32(0.5) * (x[0][mask[0]].min() + x[0][mask[0]].max())


def test_median_ray_parallax_matches_jax(two_views):
    T1, T2, uv1, uv2 = two_views
    x1, x2 = uv1 / F, uv2 / F
    R = (T2[:3, :3] @ T1[:3, :3].T).astype(np.float32)
    mask = np.random.default_rng(2).random(len(x1)) > 0.3
    mj = jtri.median_ray_parallax(jnp.asarray(R), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    mt = ttri.median_ray_parallax(_t(R), _t(x1), _t(x2), _t(mask))
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-5)
