"""The port's small-matrix lowerings against the JAX package's
(tests/test_linalg_lowering.py): ``smallest_eigvec_psd`` on generic,
rank-deficient and f32-indefinite minimal-sample Grams against JAX's on the
same numpy inputs, and ``nullspace_vector``'s dispatch, ``eigh`` bit for bit
on CPU tensors. JAX is imported inside the tests that compare with it, so
the ``cuda`` case also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_linalg_lowering.py``.

Tolerances. Where the nullspace is one-dimensional both packages' inverse
iterations converge on the same vector: atol 5e-4 (rank 11 of 12), and on
minimal-sample Grams (where the shift dominates the f32 indefiniteness)
each row within the first-order bound of its conditioning, f32 epsilon
over the relative gap and never below 1e-5, of JAX's function in float64;
both packages' f32 runs move with the host.
A two-dimensional nullspace leaves the direction inside it to the f32
rounding of the two tiny eigenvalues: there each vector is held to JAX's
own residual bound and the two to 2e-2.

The ``cuda`` case counts the host syncs of one mono tracking step and one
self-promoting chunk on the card and finds none in ``ops/linalg.py``,
``ops/lie.py``, ``ops/pnp.py`` or ``ops/triangulation.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)

SYNC_FREE = ("ops/linalg.py", "ops/lie.py", "ops/pnp.py", "ops/triangulation.py")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _jax_psd(AtA):
    import jax.numpy as jnp

    from visual_slam_tpu.ops.linalg import smallest_eigvec_psd

    return np.asarray(smallest_eigvec_psd(jnp.asarray(AtA)))


def _port_psd(AtA):
    return tlinalg.smallest_eigvec_psd(torch.from_numpy(AtA)).numpy()


def _signed(x, ref):
    """x with each row's sign turned to ``ref``'s (eigenvectors up to sign)."""
    return x * np.sign(np.sum(x * ref, axis=-1, keepdims=True))


def test_smallest_eigvec_psd_generic_matches_jax(rng):
    B = rng.normal(size=(16, 7, 9)).astype(np.float32)
    AtA = np.einsum("bij,bik->bjk", B, B)  # rank 7 of 9: a 2-dim nullspace
    x_t, x_j = _port_psd(AtA), _jax_psd(AtA)
    scale = np.trace(AtA, axis1=-2, axis2=-1)
    for x in (x_t, x_j):
        assert np.all(np.linalg.norm(np.einsum("bij,bj->bi", AtA, x), axis=-1) < 2e-3 * scale)
        np.testing.assert_allclose(np.linalg.norm(x, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(_signed(x_t, x_j), x_j, atol=2e-2)


def test_smallest_eigvec_psd_rank_deficient_matches_jax(rng):
    B = rng.normal(size=(8, 11, 12)).astype(np.float32)
    AtA = np.einsum("bij,bik->bjk", B, B)  # rank 11 of 12: a 1-dim nullspace
    x_t, x_j = _port_psd(AtA), _jax_psd(AtA)
    np.testing.assert_allclose(_signed(x_t, x_j), x_j, atol=5e-4)
    v = np.linalg.eigh(AtA.astype(np.float64))[1][..., 0]
    assert np.all(np.abs(np.sum(x_t * v, axis=-1)) > 0.999)


GAP_MULTIPLE = 1.0  # of f32 epsilon over the relative gap: the null vectors' tolerance


def _minimal_sample_grams(rng):
    """20 minimal-sample Grams (rank 8 of 9), f32."""
    return np.stack([B.T @ B for B in (1000.0 * rng.normal(size=(20, 8, 9))).astype(np.float32)])


def _gap_bound(AtA):
    """Each row's tolerance on its null vector: the first-order perturbation
    bound of an eigenvector, GAP_MULTIPLE x f32's epsilon over the relative
    gap lam_2 / trace of the Jacobi-equilibrated Gram (the matrix both
    packages iterate on), and never below 1e-5."""
    A = AtA.astype(np.float64)
    d = np.sqrt(np.einsum("bii->bi", A))
    Ae = A / d[:, :, None] / d[:, None, :]
    rel_gap = np.linalg.eigvalsh(Ae)[:, 1] / np.trace(Ae, axis1=-2, axis2=-1)
    return np.maximum(GAP_MULTIPLE * np.finfo(np.float32).eps / rel_gap, 1e-5)


def _assert_within_gap_bound(x, x_64, AtA):
    """Each row of ``x`` (up to its sign) within ``_gap_bound`` of ``x_64``."""
    err = np.abs(_signed(x, x_64) - x_64).max(axis=-1)
    bound = _gap_bound(AtA)
    bad = np.nonzero(~(err <= bound))[0]
    assert bad.size == 0, f"rows {bad.tolist()}: errors {err[bad].tolist()} above their bounds {bound[bad].tolist()}"



def test_smallest_eigvec_psd_minimal_sample_f32_indefinite_matches_jax(rng):
    """A minimal-sample Gram (rank n-1 exactly) rounds indefinite in f32:
    the shift keeps the factor finite, in the port as in JAX.

    Both packages' f32 runs are held, row by row, to the JAX function
    evaluated in float64 on the same Grams (x64 on), within the first-order
    perturbation bound of an eigenvector: GAP_MULTIPLE (1) x f32's epsilon
    over the row's relative gap lam_2 / trace of the equilibrated Gram, and
    never below 1e-5. How far an f32 run lands from the exact iteration is
    its rounding, which the host's code path moves (MKL_CBWR, XLA's f32
    codegen): on row 4 here (relative gap 1.35e-4, bound 8.9e-4) the port
    lands 1.5e-5 off on an Intel Xeon and XLA's f32 2.1e-5, where a fixed
    1e-5 failed; every row lands within 0.06 of its bound in both packages,
    under this host's default path and MKL_CBWR=COMPATIBLE, AVX2 and AVX512.
    On a well-conditioned row the bound is 1e-5
    (``test_gap_bound_refuses_a_wrong_vector``)."""
    import jax

    AtA = _minimal_sample_grams(rng)
    x_t, x_j = _port_psd(AtA), _jax_psd(AtA)
    with jax.enable_x64(True):
        x_64 = _jax_psd(AtA.astype(np.float64))
    assert x_64.dtype == np.float64
    for x in (x_t, x_j):
        assert np.all(np.isfinite(x))
        np.testing.assert_allclose(np.linalg.norm(x, axis=-1), 1.0, atol=1e-4)
        _assert_within_gap_bound(x, x_64, AtA)


@pytest.mark.parametrize("fault", ["sign_pattern", "off_by_1e-3"])
def test_gap_bound_refuses_a_wrong_vector(rng, fault):
    """The conditioning-scaled bound still refuses a vector with one
    component's sign flipped, or one 1e-3 off on a well-conditioned row."""
    AtA = _minimal_sample_grams(rng)
    x_64 = np.linalg.eigh(AtA.astype(np.float64))[1][..., 0]
    _assert_within_gap_bound(x_64, x_64, AtA)
    row = int(np.argmax(_gap_bound(AtA) == 1e-5))
    assert _gap_bound(AtA)[row] == 1e-5  # a row the floor decides: well conditioned
    for r in (row, int(np.argmax(_gap_bound(AtA)))):  # and the worst-conditioned row
        x = x_64.copy()
        if fault == "sign_pattern":
            k = int(np.argmax(np.abs(x[r])))
            x[r, k] = -x[r, k]
        elif r == row:
            x[r, 0] += 1e-3
        else:
            continue
        with pytest.raises(AssertionError):
            _assert_within_gap_bound(x, x_64, AtA)


def test_smallest_eigvec_psd_failed_factor_is_nan_like_jax():
    """A Gram no shift makes positive definite fails its Cholesky: NaN, as
    JAX's factor gives, with nothing read back to the host."""
    AtA = np.diag(np.array([1.0, -1.0, 2.0], np.float32))[None].repeat(2, 0)
    AtA[1] = np.eye(3, dtype=np.float32) * 2.0 + 0.5
    x_t, x_j = _port_psd(AtA), _jax_psd(AtA)
    assert np.isnan(x_t[0]).all() and np.isnan(x_j[0]).all()
    np.testing.assert_allclose(_signed(x_t[1:], x_j[1:]), x_j[1:], atol=1e-5)


def test_nullspace_vector_cpu_is_eigh(rng):
    """On CPU tensors the dispatcher returns ``eigh``'s vector bit for bit,
    as JAX's does on its CPU backend."""
    B = rng.normal(size=(6, 11, 12)).astype(np.float32)
    AtA = torch.from_numpy(np.einsum("bij,bik->bjk", B, B))
    np.testing.assert_array_equal(tlinalg.nullspace_vector(AtA).numpy(), torch.linalg.eigh(AtA)[1][..., :, 0].numpy())


@pytest.mark.cuda
def test_tracking_step_and_chunk_make_no_sync_in_the_small_solvers():
    """A mono tracking step with the local map and a self-promoting chunk
    (every frame promotes, so ``promote_block`` triangulates) on the card:
    no host sync from the four ops files; the step's pose within 0.01 /
    0.06 of the same step on the CPU (tests/test_torch_pipeline.py's
    bounds), which takes ``eigh`` and the SVDs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from render import camera_path, make_world, render_with_depth

    from visual_slam_tpu_torch import pipeline as tp

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import count_syncs

    nf, w, h, f = 256, 320, 240, 260.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]], np.float32)
    kw = dict(num_features=nf, fast_threshold=12.0, n_levels=2, grid=4, pnp_hypotheses=64, local_map=True)
    world = make_world(np.random.default_rng(4))
    Ts = camera_path(6, step=0.3)
    frames, zbufs = zip(*[render_with_depth(world, T, K, w, h) for T in Ts])
    frames = [np.asarray(x, np.float32) for x in frames]
    steps = {d: tp.make_track_step(K, device=d, **kw) for d in ("cpu", "cuda")}
    f0 = steps["cpu"].detect(torch.from_numpy(frames[0]))
    xy, valid = f0.xy.numpy(), f0.valid.numpy()
    lm, has = np.zeros((nf, 3), np.float32), np.zeros(nf, bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < w and 0 <= v < h and zbufs[0][v, u] > 0.5:
            lm[i] = (np.linalg.inv(K) @ np.array([xy[i, 0], xy[i, 1], 1.0])) * float(zbufs[0][v, u])
            has[i] = True
    states = {d: tp.init_track_state(f0, lm, has, np.eye(4), seed=0, local_map_size=512, device=d)
              for d in ("cpu", "cuda")}
    states = {d: tp.set_local_map(s, lm, f0.desc, has) for d, s in states.items()}
    outs = {}
    for d in ("cpu", "cuda"):
        states[d], outs[d] = steps[d](states[d], torch.from_numpy(frames[1]).to(d))  # warm-up
    torch.cuda.synchronize()
    with count_syncs(torch) as step_syncs:
        states["cuda"], out = steps["cuda"](states["cuda"], torch.from_numpy(frames[2]).cuda())
        torch.cuda.synchronize()
    states["cpu"], out_cpu = steps["cpu"](states["cpu"], torch.from_numpy(frames[2]))
    T_g, T_c = out.T_w2c.cpu().numpy(), out_cpu.T_w2c.numpy()
    np.testing.assert_allclose(T_g[:3, :3], T_c[:3, :3], atol=0.01)
    np.testing.assert_allclose(T_g[:3, 3], T_c[:3, 3], atol=0.06)
    chunk = tp.make_track_chunk_promote(steps["cuda"], K, min_inliers=10, keyframe_interval=0)
    imgs = torch.from_numpy(np.stack(frames[3:6])).cuda()
    chunk(states["cuda"], 0, T_g, imgs)  # warm-up
    torch.cuda.synchronize()
    with count_syncs(torch) as chunk_syncs:
        _, _, _, outs_c, recs = chunk(states["cuda"], 0, T_g, imgs)
        torch.cuda.synchronize()
    assert bool(recs.promoted.all().cpu())  # every frame ran promote_block's triangulation and promoted
    bad = {k: n for at in (step_syncs, chunk_syncs) for k, n in at.items() if k.startswith(SYNC_FREE)}
    assert not bad, (dict(step_syncs), dict(chunk_syncs))
