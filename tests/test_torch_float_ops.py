"""The port's feature-family ops against the JAX package on the CPU: the
Shi-Tomasi corner map and its ORB detector, the GradHist detectors and
descriptor, and the float route at every matching site (the L2 matrix,
``match_descriptors`` and its batched form, ``guided_match``, the stereo
match, the keyframe signature). Mirrors tests/test_float_descriptors.py and
test_features.py's Shi-Tomasi tests on the port. Inputs are numpy arrays
made from a seed, or rendered frames (tests/render.py); the JAX package
runs jitted, as its own tests run it.

Tolerances. The Shi-Tomasi map within 1e-3 of its maximum (the two
convolutions sum in another order), at least 99.5 % of the pixels on the
same side of the threshold. Keypoints: at least 98 % of JAX's valid ones
at the same pixel and octave; angles within 1e-4 rad away from the wrap;
GradHist descriptors within 1e-4 (1e-5 fed the same patches and angles);
Shi-Tomasi ORB descriptors at least 99 % equal bits (the blur's rounding:
XLA contracts its multiply-adds, ROADMAP). Matching: the L2 matrix at rtol
1e-5 with a 2e-6 floor (|a|^2 + |b|^2 - 2ab cancels: on unit-norm rows an
f32 rounding of 2e-7 in the square is 1.3e-6 at a distance of 0.08); the
float matches equal wherever JAX's best and second distances
differ by more than 1e-5. The signature's codebook bit for bit, its
histogram within 1e-6.

JAX is imported inside the tests that compare with it, so the ``cuda`` case
(the four detectors on the card against the CPU) also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_float_ops.py``.
"""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.frontend import feature_manager as tfm
from visual_slam_tpu_torch.interop import features_from_numpy
from visual_slam_tpu_torch.ops import fast as tfast
from visual_slam_tpu_torch.ops import matching as tmatch

torch.set_num_threads(1)

DETECT = dict(num_features=384, n_levels=2, grid=4)
FAMILY_PARAMS = {"shi_tomasi_orb": DETECT, "gradhist": dict(DETECT, fast_threshold=12.0),
                 "shi_tomasi_gradhist": DETECT, "sift": dict(num_features=384, n_octaves=3, contrast_threshold=0.02)}


def _frames(n=2, step=0.3):
    from render import render_sequence

    frames, _, _, _ = render_sequence(np.random.default_rng(42), n_frames=n, step=step)
    return [f.astype(np.float32) for f in frames]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_keypoints(fa, fb, xy_atol=1e-3):
    """The valid keypoints of ``fa`` with a valid keypoint of ``fb`` at the
    same position (within ``xy_atol``) and octave, in whatever slot (one
    keypoint more or less shifts every weaker one by a slot): (slots of fa,
    their slots in fb, the count of fa's valid keypoints)."""
    ia, ib = np.nonzero(_np(fa.valid))[0], np.nonzero(_np(fb.valid))[0]
    d = np.abs(_np(fa.xy)[ia][:, None, :] - _np(fb.xy)[ib][None, :, :]).max(axis=-1)
    d = np.where(_np(fa.octave)[ia][:, None] == _np(fb.octave)[ib][None, :], d, np.inf)
    j = d.argmin(axis=1) if len(ib) else np.zeros(len(ia), int)
    ok = d[np.arange(len(ia)), j] <= xy_atol if len(ib) else np.zeros(len(ia), bool)
    return ia[ok], ib[j[ok]], len(ia)


def angle_gap(a, b):
    d = np.abs(_np(a) - _np(b))
    return np.minimum(d, 2 * np.pi - d)


def bit_share(da, db, rows_a, rows_b):
    a = np.ascontiguousarray(_np(da)[rows_a]).view(np.uint32)
    b = np.ascontiguousarray(_np(db)[rows_b]).view(np.uint32)
    bits = lambda w: (w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1  # noqa: E731
    return float((bits(a) == bits(b)).mean())


@pytest.fixture(scope="module")
def frame():
    return _frames(1)[0]


def test_shi_tomasi_scores_match_jax(frame):
    import jax.numpy as jnp

    from visual_slam_tpu.ops import fast as jfast
    from visual_slam_tpu_torch.ops import pyramid as tpyr

    lvl1 = tpyr.build_pyramid(torch.from_numpy(frame), 2, 1.2)[1].numpy()  # non-integer grey levels
    for img in (frame, lvl1):
        ref = np.asarray(jfast.shi_tomasi_scores(jnp.asarray(img)))
        got = tfast.shi_tomasi_scores(torch.from_numpy(img)).numpy()
        assert np.abs(got - ref).max() <= 1e-3 * ref.max()
        assert ((got > 0) == (ref > 0)).mean() >= 0.995
    # A (B, H, W) batch thresholds each frame at its own maximum.
    pair = tfast.shi_tomasi_scores(torch.from_numpy(np.stack([frame, 0.5 * frame])))
    np.testing.assert_array_equal(pair[0].numpy(), tfast.shi_tomasi_scores(torch.from_numpy(frame)).numpy())


def test_shi_tomasi_finds_square_corners():
    """Mirror of test_features.py: the min-eigenvalue response peaks at the
    square's corners, not on its edges."""
    img = np.full((96, 128), 100.0, np.float32)
    img[30:60, 40:80] = 220.0
    scores = tfast.shi_tomasi_scores(torch.from_numpy(img), quality_level=0.2)
    peaks = np.argwhere(tfast.nms(scores).numpy() > 0)
    assert len(peaks) >= 4
    for c in ([30, 40], [30, 79], [59, 40], [59, 79]):
        assert np.linalg.norm(peaks - np.array(c), axis=1).min() <= 3.0, c
    for e in ([30, 60], [59, 60], [45, 40], [45, 79]):
        assert np.linalg.norm(peaks - np.array(e), axis=1).min() > 4.0, e


@pytest.mark.parametrize("name", ["shi_tomasi_orb", "gradhist", "shi_tomasi_gradhist"])
def test_detector_matches_jax(frame, name):
    from visual_slam_tpu.frontend import feature_manager as jfm

    ref = jfm.feature_factory(name, **FAMILY_PARAMS[name]).detectAndCompute(frame)
    det = tfm.feature_factory(name, device="cpu", **FAMILY_PARAMS[name])
    got = det.detectAndCompute(frame)
    assert det.desc_words == jfm.feature_factory(name, **FAMILY_PARAMS[name]).desc_words == got.desc.shape[1]
    ir, ig, n_ref = same_keypoints(ref, got)
    assert n_ref > 100 and len(ir) >= 0.98 * n_ref
    assert angle_gap(np.asarray(ref.angle)[ir], got.angle.numpy()[ig]).max() <= 1e-4
    if det.desc_words == 128:
        d_ref = np.asarray(ref.desc).view(np.float32)[ir]
        np.testing.assert_allclose(got.desc.view(torch.float32).numpy()[ig], d_ref, rtol=0, atol=1e-4)
    else:
        assert bit_share(ref.desc, got.desc, ir, ig) >= 0.99


def test_gradhist_descriptors_on_same_patches():
    import jax.numpy as jnp

    from visual_slam_tpu.ops import floatdesc as jfd
    from visual_slam_tpu_torch.ops import floatdesc as tfd

    rng = np.random.default_rng(5)
    patches = (rng.uniform(0, 255, (96, 32, 32)) + 40 * np.sin(np.arange(32) / 3.0)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, 96).astype(np.float32)
    ref = np.asarray(jfd.gradhist_descriptors(jnp.asarray(patches), jnp.asarray(angles)))
    got = tfd.gradhist_descriptors(torch.from_numpy(patches), torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tfd._cell_weights_np(), np.asarray(jfd._CELL_W_FLAT))


def test_shi_tomasi_orb_matches_across_views():
    """Mirror of test_features.py's Shi-Tomasi detector test on the port:
    detect + describe + match recovers an image translation."""
    from test_features import textured_image

    img = textured_image(np.random.default_rng(0), h=128, w=160)
    dy, dx = 4, 6
    img2 = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    det = tfm.feature_factory("shi_tomasi_orb", num_features=128, fast_threshold=20.0, n_levels=1, grid=4,
                              device="cpu")
    assert det.fast_threshold == 0.01  # FAST-unit configs map to cv2's quality level
    f1, f2 = det.detectAndCompute(img), det.detectAndCompute(img2)
    assert int(f1.valid.sum()) > 60
    res = tmatch.match_descriptors(f1.desc, f2.desc, f1.valid, f2.valid, f1.angle, f2.angle, ratio=0.8)
    ok, ti = res["valid"].numpy(), res["train_idx"].numpy()
    assert ok.sum() > 20
    disp = f2.xy.numpy()[ti[ok]] - f1.xy.numpy()[ok]
    np.testing.assert_allclose(np.median(disp, axis=0), [dx, dy], atol=1.0)


@pytest.fixture(scope="module")
def gradhist_pair():
    """JAX's GradHist features of two rendered views (both packages match
    the same blocks)."""
    from visual_slam_tpu.frontend import feature_manager as jfm

    det = jfm.feature_factory("gradhist", **FAMILY_PARAMS["gradhist"])
    f0, f1 = (det.detectAndCompute(f) for f in _frames(2))
    return f0, f1


def _decided(best, second):
    """Queries whose match no f32 rounding can flip: JAX's best and second
    distances more than 1e-5 apart."""
    return np.asarray(second) - np.asarray(best) > 1e-5


def test_l2_distance_matrix_matches_jax(gradhist_pair):
    from visual_slam_tpu.ops import matching as jmatch

    f0, f1 = gradhist_pair
    ref = np.asarray(jmatch.l2_distance_matrix(f1.desc, f0.desc, f1.valid, f0.valid))
    t0, t1 = features_from_numpy(f0), features_from_numpy(f1)
    got = tmatch.l2_distance_matrix(t1.desc, t0.desc, t1.valid, t0.valid).numpy()
    both = ref < 1e8
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(got[~both], ref[~both])
    assert tmatch.is_binary_desc(torch.zeros(3, 8)) and not tmatch.is_binary_desc(t0.desc)


def test_float_match_descriptors_match_jax(gradhist_pair):
    from visual_slam_tpu.ops import matching as jmatch

    f0, f1 = gradhist_pair
    ref = jmatch.match_descriptors(f1.desc, f0.desc, f1.valid, f0.valid, f1.angle, f0.angle, ratio=0.8,
                                   use_orientation=True)
    t0, t1 = features_from_numpy(f0), features_from_numpy(f1)
    got = tmatch.match_descriptors(t1.desc, t0.desc, t1.valid, t0.valid, t1.angle, t0.angle, ratio=0.8,
                                   use_orientation=True)
    dist = np.asarray(jmatch.l2_distance_matrix(f1.desc, f0.desc, f1.valid, f0.valid))
    srt = np.sort(dist, axis=1)
    dec = _decided(srt[:, 0], srt[:, 1])
    assert dec.mean() > 0.9
    np.testing.assert_array_equal(got["valid"].numpy()[dec], np.asarray(ref["valid"])[dec])
    ok = np.asarray(ref["valid"]) & dec
    assert ok.sum() > 80
    np.testing.assert_array_equal(got["train_idx"].numpy()[ok], np.asarray(ref["train_idx"])[ok])
    np.testing.assert_allclose(got["distance"].numpy()[ok], np.asarray(ref["distance"])[ok], rtol=1e-5, atol=2e-6)


def test_float_match_batched_matches_jax(gradhist_pair):
    import jax.numpy as jnp

    from visual_slam_tpu.ops import matching as jmatch

    f0, f1 = gradhist_pair
    stack = lambda *a: np.stack([np.asarray(x) for x in a])  # noqa: E731
    cands = [(f0.desc, f0.valid, f0.angle), (f1.desc, f1.valid, f1.angle)]
    desc_c, valid_c, angle_c = (stack(*[c[k] for c in cands]) for k in range(3))
    ref = jmatch.match_descriptors_batched(f1.desc, jnp.asarray(desc_c), f1.valid, jnp.asarray(valid_c), f1.angle,
                                           jnp.asarray(angle_c))
    t1 = features_from_numpy(f1)
    got = tmatch.match_descriptors_batched(t1.desc, torch.from_numpy(desc_c.view(np.int32)), t1.valid,
                                           torch.from_numpy(valid_c), t1.angle, torch.from_numpy(angle_c))
    for c, (d, v, _) in enumerate(cands):
        dist = np.asarray(jmatch.l2_distance_matrix(f1.desc, d, f1.valid, v))
        srt = np.sort(dist, axis=1)
        dec = _decided(srt[:, 0], srt[:, 1])
        np.testing.assert_array_equal(got["valid"][c].numpy()[dec], np.asarray(ref["valid"])[c][dec])
        ok = np.asarray(ref["valid"])[c] & dec
        np.testing.assert_array_equal(got["train_idx"][c].numpy()[ok], np.asarray(ref["train_idx"])[c][ok])
    assert got["n_matches"].shape == (2,) and int(got["n_matches"][1]) > 300  # the block against itself


def _guided_inputs():
    """test_float_family_slam.py's test_float_guided_match_roundtrip inputs."""
    rng = np.random.default_rng(3)
    M = 64
    desc = rng.normal(size=(M, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-0.5, 0.5, M), rng.uniform(-0.4, 0.4, M), rng.uniform(4, 8, M)], 1).astype(np.float32)
    uv = ((pts[:, :2] / pts[:, 2:3]) * 100.0 + np.array([80.0, 60.0])).astype(np.float32)
    return pts, desc, K, uv


def test_float_guided_match_matches_jax():
    import jax.numpy as jnp

    from visual_slam_tpu.ops.guided_matching import guided_match as jguided
    from visual_slam_tpu_torch.ops.guided_matching import guided_match

    pts, desc, K, uv = _guided_inputs()
    M = len(pts)
    # Perturbed keypoint descriptors and positions: the ratio and radius gates decide some.
    rng = np.random.default_rng(4)
    kdesc = desc + rng.normal(scale=0.05, size=desc.shape).astype(np.float32)
    kdesc /= np.linalg.norm(kdesc, axis=1, keepdims=True)
    kxy = (uv + rng.normal(scale=2.0, size=uv.shape)).astype(np.float32)
    for kd, kp, radius in ((desc, uv, 5.0), (kdesc, kxy, 6.0)):
        ref = jguided(jnp.asarray(pts), jnp.asarray(desc.view(np.uint32)), jnp.ones(M, bool), jnp.eye(4),
                      jnp.asarray(K), jnp.asarray(kp), jnp.asarray(kd.view(np.uint32)), jnp.ones(M, bool), 160.0,
                      120.0, radius_px=radius)
        ones = torch.ones(M, dtype=torch.bool)
        got = guided_match(torch.from_numpy(pts), torch.from_numpy(desc.view(np.int32)), ones, torch.eye(4),
                           torch.from_numpy(K), torch.from_numpy(kp), torch.from_numpy(kd.view(np.int32)), ones,
                           160.0, 120.0, radius_px=radius)
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
        np.testing.assert_array_equal(got["lm_idx"].numpy(), np.asarray(ref["lm_idx"]))
        np.testing.assert_allclose(got["pts3d"].numpy(), np.asarray(ref["pts3d"]))
    ok = got["valid"].numpy()
    assert ok.sum() > M * 0.8 and (got["lm_idx"].numpy()[ok] == np.nonzero(ok)[0]).mean() > 0.95


def test_float_stereo_match_matches_jax(gradhist_pair):
    """The stereo match on float blocks: the row-gated L2 matrix. The right
    view is the left one's features shifted 8 px left (a constant
    disparity), with their descriptors perturbed."""
    import jax.numpy as jnp

    from visual_slam_tpu.ops.stereo import stereo_feature_depths as jstereo
    from visual_slam_tpu_torch.ops.stereo import stereo_feature_depths

    f0, _ = gradhist_pair
    rng = np.random.default_rng(6)
    xy_l = np.asarray(f0.xy)
    xy_r = (xy_l - np.array([8.0, 0.0]) + rng.normal(scale=0.3, size=xy_l.shape)).astype(np.float32)
    d_l = np.asarray(f0.desc).view(np.float32)
    d_r = d_l + rng.normal(scale=0.02, size=d_l.shape).astype(np.float32)
    v = np.asarray(f0.valid)
    ref = jstereo(jnp.asarray(xy_l), jnp.asarray(d_l.view(np.uint32)), jnp.asarray(v), jnp.asarray(xy_r),
                  jnp.asarray(d_r.view(np.uint32)), jnp.asarray(v), 40.0)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = stereo_feature_depths(t(xy_l), t(d_l.view(np.int32)), t(v), t(xy_r), t(d_r.view(np.int32)), t(v), 40.0)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    ok = np.asarray(ref["valid"])
    assert ok.sum() > 0.8 * v.sum()
    np.testing.assert_array_equal(got["right_idx"].numpy()[ok], np.asarray(ref["right_idx"])[ok])
    np.testing.assert_allclose(got["z"].numpy()[ok], np.asarray(ref["z"])[ok], rtol=1e-6)


def test_float_signature_matches_jax(gradhist_pair):
    from visual_slam_tpu.loop_closing import signature as jsig
    from visual_slam_tpu_torch.loop_closing import signature as tsig

    np.testing.assert_array_equal(tsig._make_codebook_float(), jsig._make_codebook_float())
    np.testing.assert_array_equal(tsig._CODEBOOK_F.numpy(), np.asarray(jsig._CODEBOOK_F))
    f0, f1 = gradhist_pair
    descs = np.stack([np.asarray(f0.desc), np.asarray(f1.desc)])
    valids = np.stack([np.asarray(f0.valid), np.asarray(f1.valid)])
    ref = jsig.batch_signatures(descs, valids)
    got = tsig.batch_signatures(torch.from_numpy(descs.view(np.int32)), torch.from_numpy(valids))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    one = tsig.keyframe_signature(torch.from_numpy(descs[0].view(np.int32)), torch.from_numpy(valids[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(jsig.keyframe_signature(f0.desc, f0.valid)), rtol=0, atol=1e-6)


def test_gradhist_cross_view_matching():
    """Mirror of test_float_descriptors.py: L2 matching of GradHist across a
    viewpoint change on the rendered world (JAX measured 136 of 256)."""
    from render import camera_path, make_world, render

    world = make_world(np.random.default_rng(0))
    Ts = camera_path(2, step=0.25)
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1.0]])
    det = tfm.feature_factory("gradhist", num_features=256, fast_threshold=12.0, n_levels=2, grid=4, device="cpu")
    f0, f1 = (det.detectAndCompute(render(world, T, K, 320, 240)) for T in Ts)
    r = tfm.matcher_factory("l2", ratio=0.8).match(f1, f0)
    assert int(r["valid"].sum()) > 80


def test_gradhist_rotation_invariance():
    """Mirror of test_float_descriptors.py: a 30 degree image rotation keeps
    the matches, and the matched pairs encode the rotation."""
    from scipy.ndimage import rotate as ndrotate

    from render import camera_path, make_world, render

    world = make_world(np.random.default_rng(0))
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1.0]])
    img0 = render(world, camera_path(1, step=0.25)[0], K, 320, 240)
    imgr = ndrotate(img0, 30, reshape=False, order=1, mode="nearest")
    det = tfm.feature_factory("gradhist", num_features=256, fast_threshold=12.0, n_levels=2, grid=4, device="cpu")
    f0, fr = det.detectAndCompute(img0), det.detectAndCompute(imgr)
    r = tfm.matcher_factory("bf-l2", ratio=0.8).match(fr, f0)
    ok, ti = r["valid"].numpy(), r["train_idx"].numpy()
    assert ok.sum() > 80
    c = np.array([160.0, 120.0])
    a, b = fr.xy.numpy()[ok] - c, f0.xy.numpy()[ti[ok]] - c
    th = np.arctan2(a[:, 1], a[:, 0]) - np.arctan2(b[:, 1], b[:, 0])
    assert abs(np.degrees(np.median(np.arctan2(np.sin(th), np.cos(th)))) + 30.0) < 2.0


def test_float_detectors_take_a_stereo_batch(frame):
    """A (2, H, W) pair goes through a float detector frame by frame: the
    same blocks as two single detects, stacked."""
    det = tfm.feature_factory("gradhist", device="cpu", **FAMILY_PARAMS["gradhist"])
    pair = det.detectAndCompute(np.stack([frame, frame[:, ::-1].copy()]))
    one = det.detectAndCompute(frame)
    assert pair.desc.shape == (2, 384, 128)
    for name in ("xy", "angle", "desc", "valid"):
        assert torch.equal(getattr(pair, name)[0], getattr(one, name))


@pytest.mark.cuda
def test_detectors_on_the_card_match_the_cpu(frame):
    """Shi-Tomasi ORB, GradHist, Shi-Tomasi GradHist and DoG SIFT on the
    card against the same detector on the CPU: the CPU parity tolerances
    (SIFT's as tests/test_torch_sift.py's); K1 launches once per Shi-Tomasi
    ORB detect and never for a float family."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments_levels

    for name, params in FAMILY_PARAMS.items():
        cpu = tfm.feature_factory(name, device="cpu", **params).detectAndCompute(frame)
        patches_and_moments_levels.launches = 0
        card = tfm.feature_factory(name, device="cuda", **params).detectAndCompute(frame)
        torch.cuda.synchronize()
        assert patches_and_moments_levels.launches == (1 if name == "shi_tomasi_orb" else 0), name
        ic, ik, n = same_keypoints(cpu, card, xy_atol=2e-3 if name == "sift" else 1e-3)
        assert len(ic) >= 0.98 * n, name
        gap = angle_gap(cpu.angle.numpy()[ic], card.angle.cpu().numpy()[ik])
        if name == "shi_tomasi_orb":
            assert gap.max() <= 1e-4 and bit_share(cpu.desc, card.desc, ic, ik) >= 0.99
        else:
            atol = 5e-3 if name == "sift" else 1e-4
            assert np.median(gap) <= 1e-4 and np.percentile(gap, 98) <= (2e-2 if name == "sift" else 1e-4), name
            d_cpu = cpu.desc.view(torch.float32).numpy()[ic]
            d_card = card.desc.view(torch.float32).cpu().numpy()[ik]
            assert np.mean(np.abs(d_card - d_cpu).max(axis=1) <= atol) >= 0.98, name
