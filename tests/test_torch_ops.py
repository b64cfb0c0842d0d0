"""Ops of the torch port against the JAX package on the same numpy inputs:
geometry, pyramid, FAST/NMS/top-k, ORB constants and descriptors,
matching. Tolerances are stated per test."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.ops import detector as jdet
from visual_slam_tpu.ops import fast as jfast
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops import matching as jm
from visual_slam_tpu.ops import orb as jorb
from visual_slam_tpu.ops import projection as jproj
from visual_slam_tpu.ops import pyramid as jpyr
from visual_slam_tpu_torch.interop import desc_to_uint32
from visual_slam_tpu_torch.ops import detector as tdet
from visual_slam_tpu_torch.ops import fast as tfast
from visual_slam_tpu_torch.ops import lie as tlie
from visual_slam_tpu_torch.ops import matching as tm
from visual_slam_tpu_torch.ops import orb as torb
from visual_slam_tpu_torch.ops import projection as tproj
from visual_slam_tpu_torch.ops import pyramid as tpyr

from render import camera_path, make_world, render

torch.set_num_threads(1)

GEOM_ATOL = 1e-4  # f32 geometry, different summation orders
LEVEL_ATOL = 1e-3  # pyramid levels on the 0-255 scale


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(3)
    world = make_world(rng)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    return render(world, camera_path(1)[0], K, W, H)


def test_lie_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.8, (64, 3)).astype(np.float32)
    w[:4] *= 1e-6  # small-angle Taylor branch
    R_j = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    R_t = tlie.so3_exp(_t(w)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=GEOM_ATOL)
    t = rng.normal(0, 2, (64, 3)).astype(np.float32)
    T_j = np.asarray(jlie.make_T(jnp.asarray(R_j), jnp.asarray(t)))
    T_t = tlie.make_T(_t(R_j), _t(t)).numpy()
    np.testing.assert_array_equal(T_t, T_j)
    np.testing.assert_allclose(tlie.se3_inverse(_t(T_j)).numpy(), np.asarray(jlie.se3_inverse(jnp.asarray(T_j))), atol=GEOM_ATOL)
    np.testing.assert_allclose(tlie.rotation_angle(_t(R_j)).numpy(), np.asarray(jlie.rotation_angle(jnp.asarray(R_j))), atol=GEOM_ATOL)
    noisy = R_j + rng.normal(0, 0.05, R_j.shape).astype(np.float32)
    P_j = np.asarray(jlie.project_to_so3(jnp.asarray(noisy)))
    np.testing.assert_allclose(tlie.project_to_so3(_t(noisy)).numpy(), P_j, atol=GEOM_ATOL)


def test_projection_matches_jax():
    rng = np.random.default_rng(1)
    K = np.array([[500, 0, 320], [0, 480, 240], [0, 0, 1]], np.float32)
    T = np.asarray(jlie.make_T(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)), jnp.asarray([0.3, -0.1, 0.5], jnp.float32)))
    pts = np.stack([rng.uniform(-3, 3, 100), rng.uniform(-2, 2, 100), rng.uniform(2, 20, 100)], 1).astype(np.float32)
    uv_j, z_j = jproj.project_points(jnp.asarray(K), jnp.asarray(T), jnp.asarray(pts))
    uv_t, z_t = tproj.project_points(_t(K), _t(T), _t(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=GEOM_ATOL * 100, rtol=1e-6)  # pixels
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=GEOM_ATOL)
    Kinv = np.linalg.inv(K).astype(np.float32)
    xy = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tproj.normalize_points(_t(Kinv), _t(xy)).numpy(),
        np.asarray(jproj.normalize_points(jnp.asarray(Kinv), jnp.asarray(xy))), atol=GEOM_ATOL,
    )


def test_pyramid_matches_jax(frame):
    """Levels within 1e-3 on the 0-255 scale: the resize weights follow
    JAX's formula, the products' summation order differs."""
    lv_j = jpyr.build_pyramid(jnp.asarray(frame), 4, 1.2)
    lv_t = tpyr.build_pyramid(_t(frame), 4, 1.2)
    for a, b in zip(lv_j, lv_t):
        assert b.shape == a.shape
        assert np.abs(np.asarray(a) - b.numpy()).max() <= LEVEL_ATOL
    blur_j = np.asarray(jpyr.gaussian_blur(jnp.asarray(frame), sigma=2.0, radius=3))
    assert np.abs(tpyr.gaussian_blur(_t(frame)).numpy() - blur_j).max() <= LEVEL_ATOL


def test_fast_nms_topk_match_jax(frame):
    """FAST scores within 1e-3 (same sums, ring order); NMS, grid top-k and
    subpixel offsets fed the same score map give identical integer
    keypoints in identical slot order."""
    s_j = jfast.fast_scores(jnp.asarray(frame), 12.0)
    s_t = tfast.fast_scores(_t(frame), 12.0)
    assert np.abs(np.asarray(s_j) - s_t.numpy()).max() <= 1e-3
    n_j = jfast.nms(s_j)
    n_t = tfast.nms(_t(s_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    for k, g in ((128, 4), (300, 8)):
        yx_j, sc_j, v_j = jfast.top_k_grid(n_j, k, grid=g)
        yx_t, sc_t, v_t = tfast.top_k_grid(_t(n_j), k, grid=g)
        np.testing.assert_array_equal(yx_t.numpy(), np.asarray(yx_j))
        np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(
            tfast.subpixel_offsets(_t(n_j), yx_t).numpy(), np.asarray(jfast.subpixel_offsets(n_j, yx_j))
        )


def test_detection_keypoints_match_jax(frame):
    """Each package's own pyramid -> FAST -> NMS -> interior -> grid top-k:
    identical integer yx and slot order. A swap is allowed only between
    slots whose scores differ by less than 1e-5 relative, and is named."""
    quotas = jdet.level_quotas(256, 2, 1.2)
    lv_j = jpyr.build_pyramid(jnp.asarray(frame), 2, 1.2)
    lv_t = tpyr.build_pyramid(_t(frame), 2, 1.2)
    swaps = []
    for l, k in enumerate(quotas):
        s = jfast.nms(jfast.fast_scores(lv_j[l], 12.0))
        Hl, Wl = s.shape
        ys, xs = np.mgrid[0:Hl, 0:Wl]
        s = jnp.where(jnp.asarray((ys >= 16) & (ys < Hl - 16) & (xs >= 16) & (xs < Wl - 16)), s, 0.0)
        yx_j, sc_j, v_j = (np.asarray(x) for x in jfast.top_k_grid(s, k, grid=4))
        yx_t, sc_t, v_t, _ = tdet.detect_level(lv_t[l], k, 12.0, 4, 16)
        yx_t, sc_t = yx_t.numpy(), sc_t.numpy()
        for i in np.nonzero((yx_t != yx_j).any(1))[0]:
            swaps.append((l, i, sc_j[i], sc_t[i]))
            assert abs(sc_j[i] - sc_t[i]) <= 1e-5 * max(abs(sc_j[i]), 1.0), (l, i, yx_j[i], yx_t[i])
        np.testing.assert_array_equal(v_t.numpy(), v_j)
    print("slot swaps between near-equal scores:", swaps)


def test_orientations_match_jax(frame):
    """Intensity-centroid angles of the frame's corners (one (K, 961) x
    (961, 2) product in both packages): within 1e-4 rad, the f32 summation
    order of the moments being the only difference."""
    s = jfast.nms(jfast.fast_scores(jnp.asarray(frame), 12.0))
    yx = jfast.top_k_grid(s, 128, grid=4)[0]
    raw = jorb.extract_patches(jnp.asarray(frame), yx)
    a_t = torb.orientations(_t(raw), torch.from_numpy(torb.MOMENT_W_NP)).numpy()
    np.testing.assert_allclose(a_t, np.asarray(jorb.orientations(raw)), atol=1e-4)


def test_orb_constants_equal_jax():
    """The port's constants are the JAX package's, bit for bit."""
    np.testing.assert_array_equal(torb.sampling_matrix_np(), jorb.SAMPLING_NP)
    np.testing.assert_array_equal(torb._make_pattern(), np.asarray(jorb.PATTERN))
    np.testing.assert_array_equal(torb.MOMENT_W_NP, np.asarray(jorb._MOMENT_W))


def test_angle_bins_follow_jnp_mod():
    two_pi = 2.0 * np.pi
    a = np.array([-7.5, -two_pi, -1e-7, -0.0, 0.0, 0.2094, 3.1, two_pi, 6.3, 12.9], np.float32)
    ref = np.asarray(jnp.floor(jnp.mod(jnp.asarray(a), two_pi) / two_pi * 30).astype(jnp.int32) % 30)
    np.testing.assert_array_equal(torb.angle_bins(_t(a)).numpy(), ref)


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, (20, 8), dtype=np.uint64).astype(np.uint32)
    bits_j = np.asarray(jorb.unpack_bits(jnp.asarray(words), dtype=jnp.float32))
    words_t = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(torb.unpack_bits(words_t).numpy(), bits_j)
    np.testing.assert_array_equal(desc_to_uint32(torb.pack_bits(_t(bits_j) > 0)), words)


def test_descriptors_bit_agreement():
    """Fed the same patches and angles: bit agreement >= 99.9%, and only
    near-tie comparisons (|v0 - v1| <= 1e-2 on the 0-255 scale, where the
    f32 summation order decides) may flip. Textured patches with sensor
    noise, as on real frames (flat synthetic regions tie exactly)."""
    rng = np.random.default_rng(4)
    patches = (rng.uniform(20, 230, (300, 31, 31)) + rng.normal(0, 2.0, (300, 31, 31))).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    d_j = np.asarray(jorb.descriptors(jnp.asarray(patches), jnp.asarray(angles), jnp.asarray(jorb.SAMPLING_NP)))
    S = torch.tensor(torb.sampling_matrix_np())
    d_t = desc_to_uint32(torb.descriptors(_t(patches), _t(angles), S))
    bits_j = np.unpackbits(d_j.view(np.uint8), axis=1, bitorder="little")
    bits_t = np.unpackbits(d_t.view(np.uint8), axis=1, bitorder="little")
    flips = bits_j != bits_t
    rate = 1.0 - flips.mean()
    print(f"descriptor bit agreement {rate:.6f} ({int(flips.sum())} of {flips.size} bits)")
    assert rate >= 0.999
    samples = (_t(patches).reshape(300, -1) @ S).reshape(300, 30, 256, 2)
    vals = samples[torch.arange(300), torb.angle_bins(_t(angles))]
    gap = (vals[..., 0] - vals[..., 1]).abs().numpy()
    assert (gap[flips] <= 1e-2).all()



def test_match_descriptors_matches_jax():
    """match_descriptors (K2 path + unique-train + orientation filter) is
    exact against the JAX function on identical descriptors and angles,
    with planted ties."""
    rng = np.random.default_rng(5)
    k1, k2 = 256, 240
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint64).astype(np.uint32)
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint64).astype(np.uint32)
    d1[:120] = d2[:120] ^ (rng.random((120, 8)) < 0.03).astype(np.uint32)  # near matches
    d1[120:130] = d1[:10]  # duplicated queries: unique-train ties
    v1, v2 = rng.random(k1) > 0.1, rng.random(k2) > 0.1
    a2 = rng.uniform(-np.pi, np.pi, k2).astype(np.float32)
    a1 = np.concatenate([a2[:120] + 0.2 + rng.normal(0, 0.05, 120), rng.uniform(-np.pi, np.pi, k1 - 120)]).astype(np.float32)
    ref = jm.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
                               jnp.asarray(a1), jnp.asarray(a2), ratio=0.75, cross_check=True, use_orientation=True)
    got = tm.match_descriptors(torch.from_numpy(d1.view(np.int32)), torch.from_numpy(d2.view(np.int32)), _t(v1), _t(v2),
                               _t(a1), _t(a2), ratio=0.75, cross_check=True, use_orientation=True)
    assert int(ref["n_matches"]) > 50
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["train_idx"].numpy(), np.asarray(ref["train_idx"]))
    np.testing.assert_array_equal(got["distance"].numpy(), np.asarray(ref["distance"]))
    assert int(got["n_matches"]) == int(ref["n_matches"])
    dist = jm.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    dist_t = tm.hamming_distance_matrix(torch.from_numpy(d1.view(np.int32)), torch.from_numpy(d2.view(np.int32)), _t(v1), _t(v2))
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist))
    for a, b in zip(tm.min2(dist_t), jm.min2(dist)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tm.match_nn(dist_t, ratio=0.8), jm.match_nn(dist, ratio=0.8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_import_has_no_jax_module_in_port():
    """The port's modules never name JAX (the tests import both)."""
    import visual_slam_tpu_torch

    for name, mod in list(sys.modules.items()):
        if name.startswith("visual_slam_tpu_torch") and getattr(mod, "__file__", None):
            src = open(mod.__file__).read()
            assert "import jax" not in src and "from jax" not in src, name
    assert visual_slam_tpu_torch.__version__
