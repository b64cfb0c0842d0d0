"""Two-view epipolar geometry of the torch port against the JAX package
on the CPU: eight_point, sampson_error, ransac_essential,
ransac_fundamental, recover_pose and estimate_motion_2d2d, the RANSACs fed
the JAX sampler's minimal sets. E and F are compared up to sign; the pose
recover_pose selects is compared (the SVD's signs and order may differ).

In float32 LO-RANSAC's chain of refits is chaotic: one point crossing a
threshold changes every later refit, so the hypotheses' costs differ by up
to 10% between the two packages (and between the JAX package's jitted and
eager runs) and the argmin can fall on another hypothesis. There the
winners are held to the same inlier count (within 2), masks that differ in
at most 2 of 200 entries, costs within a factor 1.5 and poses within 1e-2
(the 8-point fit on this scene is itself 1e-3 to 7e-3 rad off the true
rotation in both packages). In float64, on draws without a near-tie among
the hypotheses, the port reproduces E, R, t and the mask to 1e-9.

Rank-deficient draws. The samplers draw with replacement, so about one
minimal set in seven repeats an index: its 8-point system has rank 7, a
two-dimensional null space, and which vector of that plane ``eigh``
returns is the LAPACK build's own choice (MKL's code path on the port's
side, XLA's on JAX's). After the refits such a hypothesis can win, in
either package, on one host and not on another. The tests that compare
the two RANSACs on injected draws therefore feed both packages the same
draws without those sets (JAX's through its sampler, patched for the
call); ``_well_posed`` checks that the sets it drops are exactly the
rank-deficient ones."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu_torch.ops import epipolar as tepi

torch.set_num_threads(1)

F = 500.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b))
    np.testing.assert_allclose(a, s * b, atol=atol)


@pytest.fixture(scope="module")
def scene():
    """200 correspondences in normalized coordinates, camera 2 translated
    1 m with a small rotation: 85% inliers with 0.2 px noise at f = 500,
    15% outliers. Clean enough that LO-RANSAC's refits bring every good
    hypothesis to the same model, so the argmin has no near-tie."""
    rng = np.random.default_rng(21)
    N = 200
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(5, 20, N)], 1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)), np.float64)
    t = np.array([-0.9, 0.1, 0.2])
    t /= np.linalg.norm(t)
    x1 = X[:, :2] / X[:, 2:3]
    pc = X @ R.T + t
    x2 = pc[:, :2] / pc[:, 2:3]
    x1 = (x1 + rng.normal(0, 0.2 / F, x1.shape)).astype(np.float32)
    x2 = (x2 + rng.normal(0, 0.2 / F, x2.shape)).astype(np.float32)
    out = rng.random(N) < 0.15
    x2[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2)).astype(np.float32)
    mask = rng.random(N) > 0.05
    return x1, x2, mask, R, t


def test_eight_point_and_sampson_match_jax(scene):
    x1, x2, mask, _, _ = scene
    w = (mask & (np.arange(len(x1)) % 3 > 0)).astype(np.float32)
    for essential in (True, False):
        Mj = jepi.eight_point(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w), essential=essential)
        Mt = tepi.eight_point(_t(x1), _t(x2), _t(w), essential=essential)
        _same_up_to_sign(Mt.numpy(), Mj, atol=1e-4)
        ej = jepi.sampson_error(Mj, jnp.asarray(x1), jnp.asarray(x2))
        et = tepi.sampson_error(_t(np.asarray(Mj)), _t(x1), _t(x2))
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4, atol=1e-12)


def _jax_cost(M, x1, x2, mask, thresh=3e-3):
    """The RANSAC's truncated Sampson cost of model M, by the JAX package."""
    e = np.asarray(jepi.sampson_error(jnp.asarray(M), jnp.asarray(x1), jnp.asarray(x2)))
    return float(np.where(mask, np.minimum(e, thresh * thresh), 0.0).sum())


def _draws(key, mask):
    return jepi._sample_minimal_sets(jax.random.split(key, 2)[0], jnp.asarray(mask), 128, 8)


def _well_posed(idx, x1, x2):
    """The minimal sets of ``idx`` (H, 8) whose 8-point system has a
    one-dimensional null space. The dropped ones are exactly the sets with
    a repeated index: checked from each set's normalized Gram matrix in
    float64, whose second-smallest eigenvalue is below 3e-16 of the largest
    for those and above 3e-9 for every other set of these scenes."""
    idx = np.asarray(idx)
    repeated = np.array([len(set(s.tolist())) < 8 for s in idx])
    w = torch.ones(8, dtype=torch.float64)
    gaps = []
    for s in idx:
        u1, S1 = tepi._hartley_normalize(torch.from_numpy(x1[s].astype(np.float64)), w)
        u2, S2 = tepi._hartley_normalize(torch.from_numpy(x2[s].astype(np.float64)), w)
        a, b, c, d = u1[:, 0], u1[:, 1], u2[:, 0], u2[:, 1]
        A = torch.stack([c * a, c * b, c, d * a, d * b, d, a, b, torch.ones_like(a)], -1).numpy()
        ev = np.linalg.eigvalsh(A.T @ A)
        gaps.append(ev[1] / ev[-1])
    np.testing.assert_array_equal(np.array(gaps) < 1e-12, repeated)
    return idx[~repeated]


@pytest.fixture
def jax_draws(monkeypatch):
    """``jax_draws(idx)``: from here on in the test, the JAX package's
    RANSACs take the minimal sets ``idx`` in place of their sampler's, as
    the port's take ``sample_idx``. ``ransac_essential`` is jitted anew
    around a new function object: jit caches its traces by function, and
    a trace holds the draws it was traced with."""
    def inject(idx):
        monkeypatch.setattr(jepi, "_sample_minimal_sets", lambda key, mask, n_hyp, k: jnp.asarray(idx))
        body = functools.partial(jepi.ransac_essential.__wrapped__)
        monkeypatch.setattr(jepi, "ransac_essential", jax.jit(body, static_argnames=("n_hyp",)))
    return inject


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_essential_with_injected_draws(scene, jax_draws, seed):
    x1, x2, mask, _, _ = scene
    key = jax.random.PRNGKey(seed)
    idx = _well_posed(_draws(key, mask), x1, x2)
    jax_draws(idx)
    ref = jepi.ransac_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), key, n_hyp=len(idx))
    got = tepi.ransac_essential(_t(x1), _t(x2), _t(mask), sample_idx=_t(idx), n_hyp=len(idx))
    np.testing.assert_allclose(_jax_cost(got["E"].numpy(), x1, x2, mask), float(got["score"]), rtol=1e-4)
    assert 1 / 1.5 < float(got["score"]) / float(ref["score"]) < 1.5
    assert np.sum(got["inliers"].numpy() != np.asarray(ref["inliers"])) <= 2
    assert abs(int(got["n_inliers"]) - int(ref["n_inliers"])) <= 2


@pytest.mark.parametrize("seed", [2, 4])
def test_estimate_motion_2d2d_float64_matches_exactly(scene, jax_draws, seed):
    """In float64 and without a near-tie among the hypotheses, the port
    reproduces the JAX package's essential matrix and pose to rounding.
    A rank-deficient draw's hypothesis is host-arbitrary, not tied: seed
    4's draws hold 21 such sets, one of which won on one host and not on
    another (module docstring), so both packages take the well-posed
    draws."""
    x1, x2, mask, _, _ = scene
    x1, x2 = x1.astype(np.float64), x2.astype(np.float64)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(seed)
        idx = _well_posed(_draws(key, mask), x1, x2)
        jax_draws(idx)
        ref = jepi.estimate_motion_2d2d(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), key, n_hyp=len(idx))
    got = tepi.estimate_motion_2d2d(_t(x1), _t(x2), _t(mask), sample_idx=_t(idx), n_hyp=len(idx))
    _same_up_to_sign(got["E"].numpy(), ref["E"], atol=1e-9)
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=1e-9)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=1e-9)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))


def test_ransac_fundamental_with_injected_draws(scene):
    x1, x2, mask, _, _ = scene
    p1, p2 = x1 * F + 320.0, x2 * F + 240.0  # pixels
    key = jax.random.PRNGKey(3)
    ref = jepi.ransac_fundamental(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key, n_hyp=128, thresh=1.0)
    idx = jepi._sample_minimal_sets(key, jnp.asarray(mask), 128, 8)
    got = tepi.ransac_fundamental(_t(p1), _t(p2), _t(mask), sample_idx=_t(idx), n_hyp=128, thresh=1.0)
    _same_up_to_sign(got["F"].numpy(), ref["F"], atol=1e-3)
    assert np.sum(got["inliers"].numpy() != np.asarray(ref["inliers"])) <= 2


def test_own_draws_find_the_motion(scene):
    """Without injected draws the port's own generator finds the same
    motion (the distribution, not the bits, is what carries over). The
    winner here is a float32 near-tie: hypotheses 78 and 7 of these draws
    end 1.7% apart in cost, in poses 1.39e-2 and 0.44e-2 from the true R,
    and MKL's code path decides which wins (1.39e-2 with this AMD EPYC's
    default path; 0.44e-2 with MKL_CBWR=COMPATIBLE, AVX, AVX2 or AVX512).
    R is held to twice that spread, 1.9e-2."""
    x1, x2, mask, R, t = scene
    res = tepi.estimate_motion_2d2d(_t(x1), _t(x2), _t(mask), torch.Generator().manual_seed(0), n_hyp=128)
    np.testing.assert_allclose(res["R"].numpy(), R, atol=1.9e-2)
    assert float(res["t"].numpy() @ t) > 0.999
    assert int(res["n_inliers"]) > 0.65 * mask.sum()


def test_estimate_motion_2d2d_with_injected_draws(scene):
    x1, x2, mask, R, t = scene
    key = jax.random.PRNGKey(5)
    ref = jepi.estimate_motion_2d2d(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), key, n_hyp=128)
    got = tepi.estimate_motion_2d2d(_t(x1), _t(x2), _t(mask), sample_idx=_t(_draws(key, mask)), n_hyp=128)
    assert 1 / 1.5 < _jax_cost(got["E"].numpy(), x1, x2, mask) / _jax_cost(np.asarray(ref["E"]), x1, x2, mask) < 1.5
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=1e-2)
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]), atol=1e-2)
    assert np.sum(got["inliers"].numpy() != np.asarray(ref["inliers"])) <= 2
    np.testing.assert_allclose(got["R"].numpy(), R, atol=1e-2)  # and both find the true motion
    assert float(got["t"].numpy() @ t) > 0.999


def test_recover_pose_picks_the_same_pose(scene):
    """Fed the same E, the pose with the most points in front of both
    cameras is the same, whatever the SVD's signs."""
    x1, x2, mask, R, t = scene
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    ref = jepi.recover_pose(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    got = tepi.recover_pose(_t(E), _t(x1), _t(x2), _t(mask))
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=1e-4)
    assert int(got["n_good"]) == int(ref["n_good"])
    np.testing.assert_array_equal(got["good"].numpy(), np.asarray(ref["good"]))
