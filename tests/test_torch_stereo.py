"""The port's stereo and RGB-D ops against the JAX package, on the CPU.

Each case feeds the same seeded numpy inputs to the JAX function (its XLA
path: none of these reaches a Pallas kernel) and to the port's:
- ``stereo_feature_depths``: ``right_idx`` and ``valid`` exactly (integer
  Hamming distances, ties to the lower index), ``z`` within 1e-6 relative,
  on tests/test_depth_tracking.py's cases (planted disparities under a
  permutation, the row gate against a descriptor twin) and the gates'
  edges (row gap at the tolerance, disparity at its bounds, invalid slots);
- ``sample_depth_at`` exactly (bounds, holes, rounding halves to even);
  ``backproject_depths`` within 1e-5 and ``backproject_np`` within 1e-12;
- ``refine_pose_gn_depth`` and ``ransac_pnp_depth`` (the JAX sampler's
  minimal sets passed in) within 1e-4 on R and t, the parity rule for
  polished poses; inliers exactly; a leading batch of two problems as the
  two solved alone;
- rectification on tests/test_rectification.py's rig: ``stereo_rectify``
  within 1e-12 (the same float64 host math), the maps and sparse
  rectification within 1e-4 px, the bilinear remap through one map within
  1e-3 of 255, and ``StereoCalibration.rectification`` / ``rectify_images``
  as JAX's (each through its own maps: 0.03 of 255 on a noise image);
- end to end, tests/test_stereo_rgbd.py's RGB-D case and its two fused
  cases (stereo, RGB-D) through the port's ``SLAM`` beside the JAX
  package's on the same world, both held to that test's bands
  (tests/depth_parity.py; its stereo case is in
  tests/test_torch_depth_facade.py);
- a stereo pair detected as one B = 2 batch against two single detects:
  keypoints (positions, octaves, sizes, validity) exactly, responses and
  angles within 1e-5, descriptors on >= 99 % of the valid bits on the CPU
  (the BRIEF product over 2 x K_l rows rounds otherwise than over K_l;
  tests/test_torch_multiseq.py); the ``cuda`` case holds the card to the
  same and >= 99.9 % of the bits, and skips here.

JAX is imported inside the tests that need it, so the ``cuda`` case also
runs where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_stereo.py``.
"""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.frontend.features import FastOrbFeature2D
from visual_slam_tpu_torch.io.calibration import MonoCalibration, StereoCalibration
from visual_slam_tpu_torch.ops import pnp as tpnp
from visual_slam_tpu_torch.ops import rectify as trect
from visual_slam_tpu_torch.ops import stereo as tst
from visual_slam_tpu_torch.ops.orb import unpack_bits
from visual_slam_tpu_torch.tracking import detect_frame_features

torch.set_num_threads(1)


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def i32(desc):
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32))


@pytest.fixture(scope="module")
def J():
    """The JAX modules the comparisons call."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from visual_slam_tpu.ops import epipolar as jepi
    from visual_slam_tpu.ops import pnp as jpnp
    from visual_slam_tpu.ops import rectify as jrect
    from visual_slam_tpu.ops import stereo as jst

    class Mods:
        pass

    m = Mods()
    m.jax, m.jnp, m.epi, m.pnp, m.rect, m.st = jax, jnp, jepi, jpnp, jrect, jst
    return m


# -- stereo_feature_depths -------------------------------------------------


def _planted(seed=0, K=64):
    """tests/test_depth_tracking.py's fixture: right keypoints at planted
    disparities bf / z under a permutation, the same descriptors."""
    rng = np.random.default_rng(seed)
    bf = 150.0
    z = rng.uniform(2, 20, K).astype(np.float32)
    xy_l = rng.uniform(20, 280, (K, 2)).astype(np.float32)
    xy_r = xy_l.copy()
    xy_r[:, 0] -= bf / z
    desc = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    perm = rng.permutation(K)
    return dict(xy_l=xy_l, desc_l=desc, valid_l=np.ones(K, bool), xy_r=xy_r[perm], desc_r=desc[perm],
                valid_r=np.ones(K, bool), bf=bf, kw={})


def _row_gate():
    """A descriptor twin on another row must not steal the match."""
    rng = np.random.default_rng(1)
    d = rng.integers(0, 2**32, (2, 8), dtype=np.uint32)
    desc = np.stack([d[0], d[0]])
    return dict(xy_l=np.array([[100.0, 100.0], [200.0, 150.0]], np.float32), desc_l=desc,
                valid_l=np.ones(2, bool), xy_r=np.array([[90.0, 100.0], [150.0, 30.0]], np.float32), desc_r=desc,
                valid_r=np.ones(2, bool), bf=100.0, kw=dict(ratio=0.0, cross_check=False))


def _gate_edges():
    """Each left keypoint has one right candidate on the edge of a gate: the
    row gap at the tolerance (in) and just past it (out), the disparity at
    the minimum (out), just above it (in), at the maximum (out), a negative
    disparity (out); plus an invalid left and an invalid right slot, and
    near-twin descriptors so ratio and cross-check decide."""
    rng = np.random.default_rng(7)
    n = 8
    xy_l = np.stack([100.0 + 50.0 * np.arange(n), 50.0 + 30.0 * np.arange(n)], 1).astype(np.float32)
    disp = np.array([5.0, 5.0, 0.5, 0.625, 60.0, -3.0, 5.0, 5.0], np.float32)  # exact in f32
    dy = np.array([2.0, 2.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    xy_r = np.stack([xy_l[:, 0] - disp, xy_l[:, 1] + dy], 1).astype(np.float32)
    desc_l = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    desc_r = desc_l.copy()
    desc_r[:, 0] ^= np.uint32(0b111)  # 3 bits off each partner
    valid_l = np.ones(n, bool)
    valid_l[6] = False
    valid_r = np.ones(n, bool)
    valid_r[7] = False
    return dict(xy_l=xy_l, desc_l=desc_l, valid_l=valid_l, xy_r=xy_r, desc_r=desc_r, valid_r=valid_r, bf=300.0,
                kw=dict(min_disparity=0.5, max_disparity=60.0))


@pytest.mark.parametrize("case", [_planted, _row_gate, _gate_edges], ids=["planted", "row_gate", "gate_edges"])
def test_stereo_feature_depths_exact(J, case):
    c = case()
    jn = J.jnp
    jr = J.st.stereo_feature_depths(jn.asarray(c["xy_l"]), jn.asarray(c["desc_l"]), jn.asarray(c["valid_l"]),
                                    jn.asarray(c["xy_r"]), jn.asarray(c["desc_r"]), jn.asarray(c["valid_r"]),
                                    c["bf"], **c["kw"])
    tr = tst.stereo_feature_depths(t(c["xy_l"]), i32(c["desc_l"]), t(c["valid_l"], torch.bool), t(c["xy_r"]),
                                   i32(c["desc_r"]), t(c["valid_r"], torch.bool), c["bf"], **c["kw"])
    ok = np.asarray(jr["valid"])
    np.testing.assert_array_equal(tr["valid"].numpy(), ok)
    np.testing.assert_array_equal(tr["right_idx"].numpy(), np.asarray(jr["right_idx"]))
    np.testing.assert_allclose(tr["z"].numpy(), np.asarray(jr["z"]), rtol=1e-6)
    np.testing.assert_allclose(tr["disparity"].numpy(), np.asarray(jr["disparity"]), rtol=1e-6)
    if case is _planted:
        assert ok.sum() >= 62
    if case is _gate_edges:
        assert ok.tolist() == [True, False, False, True, False, False, False, False]


def test_sample_depth_at_bounds_holes_rounding(J):
    depth = np.zeros((40, 60), np.float32)
    depth[10, 20] = 5.0
    depth[10, 22] = 7.5
    depth[11, 22] = np.inf
    depth[3, 59] = 2.0
    xy = np.array([[20.0, 10.0], [21.0, 10.0], [-3.0, 10.0], [20.0, 100.0], [21.5, 10.0], [22.5, 10.4],
                   [22.0, 10.6], [59.4, 3.0], [60.0, 3.0], [-0.4, 3.0]], np.float32)
    jr = J.st.sample_depth_at(J.jnp.asarray(depth), J.jnp.asarray(xy), 0.5)
    tr = tst.sample_depth_at(t(depth), t(xy), 0.5)
    np.testing.assert_array_equal(tr["valid"].numpy(), np.asarray(jr["valid"]))
    np.testing.assert_array_equal(tr["z"].numpy(), np.asarray(jr["z"]))
    assert tr["valid"].tolist() == [True, False, False, False, True, True, False, True, False, False]


def test_backproject_depths_and_np(J):
    rng = np.random.default_rng(2)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    T_c2w = np.eye(4)
    T_c2w[:3, :3] = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    T_c2w[:3, 3] = [0.5, -0.2, 1.0]
    xy = rng.uniform(0, 320, (32, 2)).astype(np.float32)
    z = rng.uniform(2, 20, 32).astype(np.float32)
    Kinv = np.linalg.inv(K)
    jo = J.st.backproject_depths(J.jnp.asarray(Kinv, J.jnp.float32), J.jnp.asarray(T_c2w, J.jnp.float32),
                                 J.jnp.asarray(xy), J.jnp.asarray(z))
    to = tst.backproject_depths(t(Kinv), t(T_c2w), t(xy), t(z))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tst.backproject_np(Kinv, T_c2w[:3, :3], T_c2w[:3, 3], xy, z),
                               J.st.backproject_np(Kinv, T_c2w[:3, :3], T_c2w[:3, 3], xy, z), rtol=0, atol=1e-12)


# -- depth-aware PnP -------------------------------------------------------


def _pnp_problem(seed, N=128, outliers=0.25, noise_px=1.0, f=300.0):
    """Points 7-13 m ahead, a pose to find, noisy observations with a share
    of gross outliers, depths with 2 % noise and a share of them missing."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (N, 3))
    pts[:, 2] += 10
    tg = np.array([0.3, -0.1, 0.5])
    a = 0.05
    Rg = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pc = pts @ Rg.T + tg
    xy = pc[:, :2] / pc[:, 2:] + rng.normal(0, noise_px / f, (N, 2))
    bad = rng.random(N) < outliers
    xy[bad] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
    z = pc[:, 2] * (1 + rng.normal(0, 0.02, N))
    z_ok = rng.random(N) < 0.8
    mask = rng.random(N) < 0.95
    return [a.astype(np.float32) for a in (pts, xy, z)] + [mask, z_ok]


def test_refine_pose_gn_depth_matches_jax(J):
    pts, xy, z, mask, z_ok = _pnp_problem(3, outliers=0.0)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jn = J.jnp
    Rj, tj = J.pnp.refine_pose_gn_depth(jn.asarray(R0), jn.asarray(t0), jn.asarray(pts), jn.asarray(xy),
                                        jn.asarray(mask, jn.float32), jn.asarray(z), jn.asarray(z_ok, jn.float32),
                                        baseline=0.5, iters=10, huber=1e-2)
    Rt, tt = tpnp.refine_pose_gn_depth(t(R0), t(t0), t(pts), t(xy), t(mask), t(z), t(z_ok), baseline=0.5,
                                       iters=10, huber=1e-2)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_ransac_pnp_depth_matches_jax_with_shared_draws(J, seed):
    pts, xy, z, mask, z_ok = _pnp_problem(seed)
    jn = J.jnp
    key = J.jax.random.PRNGKey(seed)
    thresh = 3.0 / 300.0
    jr = J.pnp.ransac_pnp_depth(jn.asarray(pts), jn.asarray(xy), jn.asarray(mask), jn.asarray(z), jn.asarray(z_ok),
                                0.5, key, n_hyp=64, thresh=thresh)
    idx = np.array(J.epi._sample_minimal_sets(key, jn.asarray(mask), 64, 6))
    tr = tpnp.ransac_pnp_depth(t(pts), t(xy), t(mask, torch.bool), t(z), t(z_ok, torch.bool), 0.5, n_hyp=64,
                               thresh=thresh, sample_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tr["R"].numpy(), np.asarray(jr["R"]), atol=1e-4)
    np.testing.assert_allclose(tr["t"].numpy(), np.asarray(jr["t"]), atol=1e-4)
    np.testing.assert_array_equal(tr["inliers"].numpy(), np.asarray(jr["inliers"]))
    assert int(tr["n_inliers"]) == int(jr["n_inliers"]) >= 60


def test_ransac_pnp_depth_batched_as_single():
    probs = [_pnp_problem(s) for s in (4, 5)]
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    idx = torch.stack([torch.randint(0, 128, (64, 6), generator=g) for g in gens])
    stack = [torch.stack([t(p[k], torch.bool if k > 2 else torch.float32) for p in probs]) for k in range(5)]
    pts, xy, z, mask, z_ok = stack
    out = tpnp.ransac_pnp_depth(pts, xy, mask, z, z_ok, 0.5, n_hyp=64, thresh=0.01, sample_idx=idx)
    for b in range(2):
        one = tpnp.ransac_pnp_depth(pts[b], xy[b], mask[b], z[b], z_ok[b], 0.5, n_hyp=64, thresh=0.01,
                                    sample_idx=idx[b])
        np.testing.assert_allclose(out["R"][b].numpy(), one["R"].numpy(), atol=1e-5)
        np.testing.assert_allclose(out["t"][b].numpy(), one["t"].numpy(), atol=1e-5)
        assert torch.equal(out["inliers"][b], one["inliers"])


# -- rectification ---------------------------------------------------------


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _rig(negative_x=False):
    """tests/test_rectification.py's unrectified rig (x2 = R x1 + T)."""
    K1 = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]])
    K2 = np.array([[330.0, 0, 165], [0, 330.0, 118], [0, 0, 1]])
    D1 = np.array([-0.12, 0.03, 0.0005, -0.0004, 0.0])
    D2 = np.array([-0.10, 0.025, -0.0003, 0.0005, 0.0])
    R = _rot("y", 1.5) @ _rot("x", -0.8) @ _rot("z", 0.5)
    C2 = np.array([-0.11 if negative_x else 0.11, 0.002, -0.004])
    return K1, D1, K2, D2, R, -R @ C2


@pytest.mark.parametrize("negative_x", [False, True])
def test_rectification_ops_match_jax(J, negative_x):
    K1, D1, K2, D2, R, T = _rig(negative_x)
    jrect = J.rect.stereo_rectify(K1, D1, K2, D2, R, T)
    rect = trect.stereo_rectify(K1, D1, K2, D2, R, T)
    for k in ("R1", "R2", "P1", "P2", "Q", "K_new"):
        np.testing.assert_allclose(rect[k], jrect[k], rtol=0, atol=1e-12)
    assert rect["baseline"] == pytest.approx(jrect["baseline"], abs=1e-15)
    H, W = 240, 320
    f32 = [np.asarray(a, np.float32) for a in (K1, D1, rect["R1"], rect["K_new"])]
    jmap = np.asarray(J.rect.undistort_rectify_map(*f32, H, W))
    tmap = trect.undistort_rectify_map(*[t(a) for a in f32], H, W)
    np.testing.assert_allclose(tmap.numpy(), jmap, atol=1e-4)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    np.testing.assert_allclose(trect.remap_bilinear(t(img), t(jmap)).numpy(),
                               np.asarray(J.rect.remap_bilinear(img, jmap)), atol=1e-3)
    pts = rng.uniform([0, 0], [W, H], (64, 2)).astype(np.float32)
    np.testing.assert_allclose(trect.rectify_pixels(*[t(a) for a in f32], t(pts)).numpy(),
                               np.asarray(J.rect.rectify_pixels(*f32, pts)), atol=1e-4)


def test_stereo_calibration_rectification_matches_jax(J):
    from visual_slam_tpu.io.calibration import MonoCalibration as JMono
    from visual_slam_tpu.io.calibration import StereoCalibration as JStereo

    K1, D1, K2, D2, R, T = _rig()
    jcal = JStereo(left=JMono(K=K1, D=D1), right=JMono(K=K2, D=D2), R=R, T=T)
    tcal = StereoCalibration(left=MonoCalibration(K=K1, D=D1), right=MonoCalibration(K=K2, D=D2), R=R, T=T)
    jr, tr = jcal.rectification(), tcal.rectification()
    assert jr.keys() == tr.keys()
    for k in ("R1", "R2", "P1", "P2", "Q", "K_new"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-12)
    rng = np.random.default_rng(3)
    img_l, img_r = (rng.uniform(0, 255, (240, 320)).astype(np.float32) for _ in range(2))
    jl, jrr, jK, jb = jcal.rectify_images(img_l, img_r)
    tl, trr, tK, tb = tcal.rectify_images(img_l, img_r, device="cpu")
    # Each package builds its own maps (within 1e-4 px): on this noise image
    # (steps up to 255 a pixel) that is up to 0.0255 of intensity.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.03)
    np.testing.assert_allclose(trr.numpy(), np.asarray(jrr), atol=0.03)
    np.testing.assert_allclose(tK, jK, rtol=0, atol=1e-12)
    assert tb == pytest.approx(jb, abs=1e-15)


# -- end to end: tests/test_stereo_rgbd.py's RGB-D and fused cases ----------


@pytest.mark.parametrize("sensor,fused", [("rgbd", False), ("stereo", True), ("rgbd", True)])
def test_depth_sensor_tracks_metric(J, sensor, fused):
    """The RGB-D case (scale-fitted ATE below 0.3 m, scale within 0.8-1.25)
    and the two fused cases (metric ATE below 0.3 m), in both packages."""
    from depth_parity import run_both

    torch.set_num_threads(2)
    try:
        runs = run_both(sensor, fused)
    finally:
        torch.set_num_threads(1)
    for impl, (state, stamps, metric, fitted) in runs.items():
        assert state == "OK" and stamps[0] == 0.0, impl
        if fused:
            assert metric["rmse"] < 0.3, (impl, metric["rmse"])
        else:
            assert 0.8 < fitted["scale"] < 1.25, (impl, fitted["scale"])
            assert fitted["rmse"] < 0.3, (impl, fitted["rmse"])


# -- a stereo pair as one detect batch ---------------------------------------


class _Tracker:
    """The detector of a ``FeatureTracker`` (``detectAndCompute``) alone."""

    def __init__(self, device):
        self.det = FastOrbFeature2D(num_features=256, fast_threshold=12.0, n_levels=2, grid=4, device=device)

    def detectAndCompute(self, img):
        return self.det.detectAndCompute(img)


class _Camera:
    has_distortion = False


def _pair():
    from depth_world import e2e_stereo_frames

    lefts, rights, _, _ = e2e_stereo_frames(2)
    return [lefts[1], rights[1]]


def _assert_pair_as_singles(device, min_bit_share):
    tracker = _Tracker(device)
    grays = _pair()
    pair = detect_frame_features(tracker, _Camera(), grays)
    for f_b, g in zip(pair, grays):
        f_1 = tracker.detectAndCompute(g)
        for name in ("xy", "octave", "size", "valid"):
            assert torch.equal(getattr(f_b, name).cpu(), getattr(f_1, name).cpu()), name
        # The pyramid's resize is a matmul: on the card a batch of two and a
        # single frame may take other GEMM kernels, so the upper levels'
        # scores and moments round otherwise in the last bits.
        for name in ("response", "angle"):
            torch.testing.assert_close(getattr(f_b, name).cpu(), getattr(f_1, name).cpu(), rtol=1e-5, atol=1e-5)
        ok = f_1.valid.cpu()
        bits_b, bits_1 = unpack_bits(f_b.desc.cpu())[ok], unpack_bits(f_1.desc.cpu())[ok]
        assert int(ok.sum()) >= 100
        assert (bits_b == bits_1).to(torch.float32).mean() >= min_bit_share


def test_stereo_pair_detected_as_one_batch():
    _assert_pair_as_singles("cpu", 0.99)


@pytest.mark.cuda
def test_stereo_pair_detected_as_one_batch_cuda():
    """On the card: one batched K1 launch for the pair, keypoints exactly
    those of two single detects, >= 99.9 % of the descriptor bits. (The
    first run on an H100 found a batch's responses a few ulps off a
    single frame's at 320x240: the pyramid's resize GEMMs.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_batched, patches_and_moments_levels

    before = (patches_and_moments_batched.launches, patches_and_moments_levels.launches)
    tracker = _Tracker("cuda")
    detect_frame_features(tracker, _Camera(), _pair())
    assert (patches_and_moments_batched.launches - before[0], patches_and_moments_levels.launches - before[1]) == (1, 0)
    _assert_pair_as_singles("cuda", 0.999)
