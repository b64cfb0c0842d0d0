"""The port's keypoint filters (``ops.keypoint_filters``), match filters
(``ops.matching.stereo_epipolar_filter``, ``region_mask_filter``) and the
match-filter dispatcher (``frontend.filters.filter_matches``) against the
JAX package's on the same seeded numpy inputs: each of
``tests/test_filters.py``'s six tests mirrored, the masks exact.

``filter_matches`` with every filter on, RANSAC-F included, runs on a
two-view scene (tests/synthetic.py's camera, 300 matches, a fifth of them
outliers): the JAX package draws its minimal sets from its module key, the
port takes them as ``sample_idx``, and both take the same well-posed draws
(sets of 8 distinct matches: a repeated index leaves the 8-point null
vector to the LAPACK build, ROADMAP Q20.1). The masks are exact there too.
"""
import functools

import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.frontend.filters import filter_matches
from visual_slam_tpu_torch.frontend.tracker import FeatureTrackingResult
from visual_slam_tpu_torch.ops import matching as tm
from visual_slam_tpu_torch.ops.detector import Features
from visual_slam_tpu_torch.ops.keypoint_filters import filter_keypoints, filter_keypoints_grid, filter_keypoints_nms

torch.set_num_threads(1)

SEEDS = [0, 1]


def _feats_np(rng, K=64, w=160, h=120):
    """test_filters.py's ``_feats`` draws as numpy arrays."""
    return dict(
        xy=rng.uniform(0, [w, h], (K, 2)).astype(np.float32),
        response=rng.uniform(1, 100, K).astype(np.float32),
        angle=rng.uniform(-np.pi, np.pi, K).astype(np.float32),
        octave=np.zeros(K, np.int32),
        size=np.full((K,), 31.0, np.float32),
        desc=rng.integers(0, 2**32, (K, 8), dtype=np.uint32),
        valid=np.ones(K, bool),
    )


def _port(f):
    d = dict(f)
    d["desc"] = d["desc"].view(np.int32)
    return Features(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _jax(f):
    import jax.numpy as jnp

    from visual_slam_tpu.ops.detector import Features as JFeatures

    return JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})


def _same_but_valid(out, f):
    for k in ("xy", "response", "angle", "octave", "size"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), f[k])
    np.testing.assert_array_equal(out.desc.numpy().view(np.uint32), f["desc"])


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_filter_caps_cells_as_jax(seed):
    from visual_slam_tpu.ops.keypoint_filters import filter_keypoints_grid as jgrid

    f = _feats_np(np.random.default_rng(seed), K=128)
    f["response"][5] = f["response"][9]  # a tie: the lower slot ranks first
    f["valid"][::7] = False
    out = filter_keypoints_grid(_port(f), 160, 120, grid=2, per_cell=5)
    ref = jgrid(_jax(f), 160, 120, grid=2, per_cell=5)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    _same_but_valid(out, f)
    xy = out.xy.numpy()[out.valid.numpy()]
    cx = (xy[:, 0] / 160 * 2).astype(int).clip(0, 1)
    cy = (xy[:, 1] / 120 * 2).astype(int).clip(0, 1)
    counts = np.zeros((2, 2), int)
    np.add.at(counts, (cy, cx), 1)
    assert counts.max() <= 5 and counts.sum() == 20


def test_grid_filter_cells_at_their_edges_as_jax():
    """Keypoints on a cell's edge (y = 47, 94, 188 of 376 and x = 155, 310
    of 1240 at grid 8) fall in the cell JAX's exact division puts them in,
    one per cell so the cap keeps each exactly when its cell is JAX's."""
    from visual_slam_tpu.ops.keypoint_filters import filter_keypoints_grid as jgrid

    f = _feats_np(np.random.default_rng(3), K=12, w=1240, h=376)
    f["xy"][:6] = [[100.0, 47.0], [100.0, 94.0], [100.0, 188.0], [155.0, 10.0], [310.0, 10.0], [100.0, 46.9]]
    f["xy"][6:] = f["xy"][:6] + np.float32(0.5)
    f["response"][:6] = 200.0
    out = filter_keypoints_grid(_port(f), 1240, 376, grid=8, per_cell=1)
    ref = jgrid(_jax(f), 1240, 376, grid=8, per_cell=1)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.valid.numpy()[:6].all()


@pytest.mark.parametrize("seed", SEEDS)
def test_nms_filter_separates_as_jax(seed):
    from visual_slam_tpu.ops.keypoint_filters import filter_keypoints_nms as jnms

    f = _feats_np(np.random.default_rng(seed), K=96)
    f["valid"][::5] = False
    out = filter_keypoints_nms(_port(f), radius=10.0)
    ref = jnms(_jax(f), radius=10.0)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    _same_but_valid(out, f)
    xy = out.xy.numpy()[out.valid.numpy()]
    for i in range(len(xy)):
        d = np.linalg.norm(xy - xy[i], axis=1)
        assert (d[d > 0] >= 10.0 - 1e-3).all() or len(xy) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_dispatcher_runs_without_logger_as_jax(seed):
    import logging

    from visual_slam_tpu.ops.keypoint_filters import filter_keypoints as jfilter

    f = _feats_np(np.random.default_rng(seed))
    kw = dict(use_grid=True, use_nms=True, grid=4, per_cell=3, nms_radius=12.0)
    out = filter_keypoints(_port(f), 160, 120, logger=None, **kw)
    ref = jfilter(_jax(f), 160, 120, logger=None, **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert int(out.valid.sum()) >= 1
    logged = filter_keypoints(_port(f), 160, 120, logger=logging.getLogger("filters"), **kw)
    np.testing.assert_array_equal(logged.valid.numpy(), out.valid.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_stereo_filter_as_jax(seed):
    import jax.numpy as jnp

    from visual_slam_tpu.ops import matching as jm

    rng = np.random.default_rng(seed)
    K = 32
    xy1 = rng.uniform(50, 100, (K, 2)).astype(np.float32)
    xy2 = xy1.copy()
    xy2[:, 0] -= 5.0  # disparity 5
    xy2[10] += [0, 8.0]  # row violation
    xy2[11, 0] = xy1[11, 0] + 3  # negative disparity
    xy2[12, 0] = xy1[12, 0] - 50  # beyond max_disparity below
    perm = rng.permutation(K)
    xy2p = np.empty_like(xy2)
    xy2p[perm] = xy2  # the right keypoints in another order, reached through ti
    ok = np.ones(K, bool)
    ok[3] = False
    for kw, dropped in ((dict(row_tolerance=2.0), {3, 10, 11}), (dict(row_tolerance=2.0, max_disparity=20.0),
                                                                 {3, 10, 11, 12})):
        out = tm.stereo_epipolar_filter(torch.from_numpy(xy1), torch.from_numpy(xy2p), torch.from_numpy(perm),
                                        torch.from_numpy(ok), **kw).numpy()
        ref = np.asarray(jm.stereo_epipolar_filter(jnp.asarray(xy1), jnp.asarray(xy2p), jnp.asarray(perm),
                                                   jnp.asarray(ok), **kw))
        np.testing.assert_array_equal(out, ref)
        assert set(np.nonzero(~out)[0].tolist()) == dropped


@pytest.mark.parametrize("seed", SEEDS)
def test_region_mask_filter_as_jax(seed):
    import jax.numpy as jnp

    from visual_slam_tpu.ops import matching as jm

    rng = np.random.default_rng(seed)
    K = 20
    xy = rng.uniform(0, 100, (K, 2)).astype(np.float32)
    xy[0] = [50, 50]
    xy[1] = [60, 45]  # on the excluded right edge
    regions = np.asarray([[40, 40, 60, 60], [0, 0, 0, 0], [70, 70, 65, 90]], np.float32)  # padding, an empty box
    inside = (xy[:, 0] >= 40) & (xy[:, 0] < 60) & (xy[:, 1] >= 40) & (xy[:, 1] < 60)
    for exclude in (True, False):
        out = tm.region_mask_filter(torch.from_numpy(xy), torch.ones(K, dtype=torch.bool), regions,
                                    exclude=exclude).numpy()
        ref = np.asarray(jm.region_mask_filter(jnp.asarray(xy), jnp.ones(K, bool), jnp.asarray(regions),
                                               exclude=exclude))
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, ~inside if exclude else inside)
    assert not out[1] and out[0]


def _results(f1, f2, ti, dist, valid):
    """The port's and the JAX package's ``FeatureTrackingResult`` of the same
    arrays."""
    import jax.numpy as jnp

    from visual_slam_tpu.frontend.tracker import FeatureTrackingResult as JResult

    port = FeatureTrackingResult(_port(f1), _port(f2), torch.from_numpy(ti), torch.from_numpy(dist),
                                 torch.from_numpy(valid))
    ref = JResult(features1=_jax(f1), features2=_jax(f2), train_idx=jnp.asarray(ti), distance=jnp.asarray(dist),
                  valid=jnp.asarray(valid))
    return port, ref


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_matches_dispatcher_as_jax(seed):
    from visual_slam_tpu.frontend.filters import filter_matches as jfilter

    rng = np.random.default_rng(seed)
    f1, f2 = _feats_np(rng), _feats_np(rng)
    dist = rng.uniform(0, 100, 64).astype(np.float32)
    port, ref = _results(f1, f2, np.arange(64), dist, np.ones(64, bool))
    kw = dict(use_ransac_fund_matrix=False, use_orientation=False, use_max_distance=True, max_distance=50.0)
    out, jout = filter_matches(port, **kw), jfilter(ref, **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_array_equal(out.valid.numpy(), dist <= 50.0)
    assert out.train_idx is port.train_idx and out.distance is port.distance


def _two_view_matches(rng, n=300, n_out=60, K=400):
    """Feature blocks of two views of a 3D cloud (tests/synthetic.py's
    camera, 0.4 m apart, a small yaw), ``n`` query slots matched through a
    permutation, ``n_out`` of them to a wrong train slot; the angles agree up
    to a common rotation except on the outliers. Returns the blocks, the
    match table and the outlier mask."""
    from synthetic import default_K

    Kc = default_K()
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(6, 14, n)], 1)
    yaw = 0.05
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    t = np.array([-0.4, 0.02, 0.05])

    def project(P):
        uv = P @ Kc.T
        return (uv[:, :2] / uv[:, 2:]).astype(np.float32)

    f1, f2 = _feats_np(rng, K=K, w=640, h=480), _feats_np(rng, K=K, w=640, h=480)
    perm = rng.permutation(K)
    f1["xy"][:n] = project(pts) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    ti = perm.copy()
    f2["xy"][perm[:n]] = project(pts @ R.T + t) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    f2["angle"][perm[:n]] = f1["angle"][:n] + np.float32(0.1)
    bad = rng.choice(n, n_out, replace=False)
    ti[bad] = perm[rng.integers(0, K, n_out)]
    ti[1] = ti[0]  # two queries on one train slot: unique_train keeps the nearer
    valid = np.zeros(K, bool)
    valid[:n] = True
    valid[5] = False
    dist = rng.uniform(0, 80, K).astype(np.float32)
    return f1, f2, ti, dist, valid, valid & (ti != perm)


def _distinct_draws(rng, mask, n_hyp=128):
    """(n_hyp, 8) minimal sets of 8 distinct entries where ``mask`` holds."""
    live = np.nonzero(mask)[0]
    return np.stack([rng.choice(live, 8, replace=False) for _ in range(n_hyp)]).astype(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_matches_every_filter_with_injected_draws_as_jax(seed, monkeypatch):
    """Every filter on in the JAX order (max distance, unique train,
    orientation, stereo rows with a loose tolerance, a region mask, RANSAC-F
    on the same draws): the masks of JAX's filter chain and of the port's
    are equal after the filters and after RANSAC-F, which keeps most of the
    inliers and drops the outliers it reaches."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.frontend import filters as jfilters
    from visual_slam_tpu.ops import epipolar as jepi

    rng = np.random.default_rng(10 + seed)
    f1, f2, ti, dist, valid, outlier = _two_view_matches(rng)
    port, ref = _results(f1, f2, ti, dist, valid)
    kw = dict(use_orientation=True, use_stereo=True, use_mask_regions=True, use_max_distance=True, use_unique=True,
              row_tolerance=400.0, min_disparity=-1e9, max_disparity=1e9, mask_regions=[[0, 0, 80, 80], [0, 0, 0, 0]],
              max_distance=70.0)
    pre = filter_matches(port, use_ransac_fund_matrix=False, **kw)
    jpre = jfilters.filter_matches(ref, use_ransac_fund_matrix=False, **kw)
    ok = pre.valid.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jpre.valid))
    assert 150 < ok.sum() < valid.sum()
    idx = _distinct_draws(rng, ok)
    monkeypatch.setattr(jepi, "_sample_minimal_sets", lambda key, mask, n_hyp, k: jnp.asarray(idx))
    # jit caches its traces by function, and a trace holds the draws it was
    # traced with: jit a new function object around the body.
    body = functools.partial(jepi.ransac_fundamental.__wrapped__)
    monkeypatch.setattr(jepi, "ransac_fundamental", jax.jit(body, static_argnames=("n_hyp",)))
    out = filter_matches(port, sample_idx=torch.from_numpy(idx), **kw)
    jout = jfilters.filter_matches(ref, **kw)
    got = out.valid.numpy()
    np.testing.assert_array_equal(got, np.asarray(jout.valid))
    inl = ok & ~outlier
    assert (got & inl).sum() > 0.9 * inl.sum()
    assert (got & outlier).sum() <= 0.25 * (ok & outlier).sum()


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_matches_own_generator_is_deterministic(seed):
    """Without draws the port's RANSAC-F draws from ``gen``, or from a new
    generator seeded with ``seed``: the same generator state, the same mask;
    no state is kept between calls."""
    rng = np.random.default_rng(20 + seed)
    f1, f2, ti, dist, valid, _ = _two_view_matches(rng)
    port, _ = _results(f1, f2, ti, dist, valid)
    a, b = filter_matches(port), filter_matches(port)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    g = filter_matches(port, gen=torch.Generator().manual_seed(21))
    np.testing.assert_array_equal(g.valid.numpy(), a.valid.numpy())
    assert 0 < int(a.valid.sum()) < int(port.valid.sum())


def _orientation_edges(k, n_bins=30):
    """angle1 (11,) for the orientation filter with angle2 = 0: five
    differences inside bin ``k`` (the dominant one), then the float32
    neighbours of bin ``k``'s lower edge and of its upper edge (one ulp
    below, on, one ulp above): the keep mask says which of them land in
    bin ``k``."""
    edges = []
    for j in (k, k + 1):
        e = np.float32(j * 2.0 * np.pi / n_bins)
        edges += [np.nextafter(e, np.float32(0.0)), e, np.nextafter(e, np.float32(10.0))]
    inside = np.full(5, (k + 0.5) * 2.0 * np.pi / n_bins)
    return np.concatenate([inside, edges]).astype(np.float32)


def _orientation_masks(device="cpu"):
    """The port's orientation filter over ``_orientation_edges`` of bins
    1-28 on ``device``: (28, 11) keep masks."""
    out = []
    for k in range(1, 29):
        a1 = torch.from_numpy(_orientation_edges(k)).to(device)
        ti = torch.arange(a1.shape[0], device=device)
        out.append(tm.orientation_filter(a1, torch.zeros_like(a1), ti, torch.ones_like(ti, dtype=torch.bool)).cpu())
    return torch.stack(out).numpy()


def test_orientation_filter_bins_at_their_edges_as_jax():
    """Angle differences on a bin's edge (the float32 neighbours of k 2 pi /
    30) fall in the bin JAX's exact division puts them in: for each bin k
    the dominant one, the edge matches it keeps are JAX's."""
    import jax.numpy as jnp

    from visual_slam_tpu.ops.matching import orientation_filter as jorient

    got = _orientation_masks()
    for k in range(1, 29):
        a1 = jnp.asarray(_orientation_edges(k))
        ref = np.asarray(jorient(a1, jnp.zeros_like(a1), jnp.arange(a1.shape[0]), jnp.ones(a1.shape[0], bool)))
        np.testing.assert_array_equal(got[k - 1], ref, err_msg=f"bin {k}")
    assert got[:, :5].all()
    assert got[:, 5:].any() and not got[:, 5:].all()  # the edges split between bins


@pytest.mark.cuda
def test_orientation_filter_bins_at_their_edges_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the filter on CUDA tensors)")
    np.testing.assert_array_equal(_orientation_masks("cuda"), _orientation_masks("cpu"))


@pytest.mark.cuda
def test_filters_on_the_card_match_the_cpu_and_jax(monkeypatch):
    """``chip_smoke.py``'s filters phase at its shapes: the deploy world's
    frames through ``FeatureTracker`` on the card, ``filter_matches`` with
    every filter (RANSAC-F on the phase's draws) and ``filter_keypoints``
    on the card, on the CPU from the same features and, where JAX is
    installed, in the JAX package: every mask equal, RANSAC-F's within
    ``chip_smoke.FILTER_RANSAC_DIFF`` entries (the card's null vectors take
    JAX's accelerator route, the CPU's ``eigh``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1 and K2)")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    import facade_world as fw

    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.frontend import FeatureTracker
    from visual_slam_tpu_torch.utils.tree import to_device

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # where JAX is installed, its CPU backend is the reference
    try:
        import jax
    except ImportError:
        jax = None
    if jax is not None:
        jax.config.update("jax_platforms", "cpu")
    frames, _, _ = fw.deploy_frames(2)
    cfg = fw.deploy_config(Config)
    cfg.feature.filter_params = dict(use_orientation=False, use_ransac_fund_matrix=False)
    f0, pairs = cs.filter_pairs(torch, np, FeatureTracker(cfg.feature, device="cuda"), frames)
    for res, kw in pairs.values():
        pre, final, idx = cs.filter_chain(torch, np, res, kw)
        f1, f2 = to_device(res.features1, "cpu"), to_device(res.features2, "cpu")
        cpu = FeatureTrackingResult(f1, f2, res.train_idx.cpu(), res.distance.cpu(), res.valid.cpu())
        pre_c, final_c, _ = cs.filter_chain(torch, np, cpu, kw, sample_idx=idx)
        np.testing.assert_array_equal(pre.cpu().numpy(), pre_c.numpy())
        assert int((final.cpu() != final_c).sum()) <= cs.FILTER_RANSAC_DIFF
        assert 20 <= int(final.sum()) < int(pre.sum()) < int(res.valid.sum())
        if jax is not None:
            import jax.numpy as jnp

            from visual_slam_tpu.frontend import filters as jfilters
            from visual_slam_tpu.ops import epipolar as jepi

            np_of = lambda f: {k: v.numpy() if k != "desc" else v.numpy().view(np.uint32)  # noqa: E731
                               for k, v in f._asdict().items()}
            _, ref = _results(np_of(f1), np_of(f2), cpu.train_idx.numpy(), cpu.distance.numpy(), cpu.valid.numpy())
            jkw = dict(kw, ransac_hypotheses=cs.FILTER_HYP)
            np.testing.assert_array_equal(pre.cpu().numpy(), np.asarray(
                jfilters.filter_matches(ref, use_ransac_fund_matrix=False, **jkw).valid))
            monkeypatch.setattr(jepi, "_sample_minimal_sets", lambda key, mask, n_hyp, k: jnp.asarray(idx.numpy()))
            body = functools.partial(jepi.ransac_fundamental.__wrapped__)
            monkeypatch.setattr(jepi, "ransac_fundamental", jax.jit(body, static_argnames=("n_hyp",)))
            jfinal = np.asarray(jfilters.filter_matches(ref, **jkw).valid)
            assert int((final.cpu().numpy() != jfinal).sum()) <= cs.FILTER_RANSAC_DIFF
    kp = filter_keypoints(f0, cs.W, cs.H, **cs.FILTER_KP_KW).valid
    kp_c = filter_keypoints(to_device(f0, "cpu"), cs.W, cs.H, **cs.FILTER_KP_KW).valid
    np.testing.assert_array_equal(kp.cpu().numpy(), kp_c.numpy())
    assert 0 < int(kp.sum()) < int(f0.valid.sum())
    if jax is not None:
        from visual_slam_tpu.ops.keypoint_filters import filter_keypoints as jfilter

        f = to_device(f0, "cpu")._asdict()
        f["desc"] = f["desc"].numpy().view(np.uint32)
        ref = jfilter(_jax({k: np.asarray(v) for k, v in f.items()}), cs.W, cs.H, **cs.FILTER_KP_KW)
        np.testing.assert_array_equal(kp.cpu().numpy(), np.asarray(ref.valid))
