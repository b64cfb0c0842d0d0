"""Kernels K1-K5 of the torch port: each plain version against the JAX
package (XLA path and Pallas interpret mode) on the CPU, and each CUDA
kernel against its plain version on the card (marked ``cuda``), the
batched forms of K1-K3 (the batched VO step) included.

The JAX package is imported inside the tests that need it, so the card's
tests also run where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.ops import match_kernels as mk
from visual_slam_tpu_torch.ops import orb as torb
from visual_slam_tpu_torch.ops.patch_kernels import (
    extract_patches32,
    extract_patches32_ref,
    patches_and_moments_batched,
    patches_and_moments_batched_ref,
    patches_and_moments_levels,
    patches_and_moments_levels_ref,
    patches_and_moments_ref,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _packed(rng, k):
    return rng.integers(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)


def _i32(desc_u32):
    return torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32))


def _image_and_keypoints(rng, H=120, W=160, K=60):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    blur = rng.uniform(0, 255, (H, W)).astype(np.float32)
    yx = np.stack([rng.integers(0, H, K), rng.integers(0, W, K)], 1).astype(np.int32)
    yx[:4] = [[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0]]  # corners: edge replication
    return img, blur, yx


def _moment_scale(raw_patches):
    """Sum of |w * p| per keypoint: the scale of the moments' rounding."""
    flat = np.abs(raw_patches.reshape(raw_patches.shape[0], -1).astype(np.float64))
    return flat @ np.abs(torb.MOMENT_W_NP.astype(np.float64))


# --- K1: patches and moments -------------------------------------------------


def test_patches_moments_ref_matches_jax(jnp):
    """Plain K1 against the XLA path (extract_patches + moment matmul) and
    the Pallas kernel in interpret mode: patches exact, moments within 1e-5
    of sum |w * p| (f32 summation order differs)."""
    from visual_slam_tpu.ops import orb as jorb
    from visual_slam_tpu.ops.pallas_patches import patches_and_moments_pallas

    rng = np.random.default_rng(11)
    img, blur, yx = _image_and_keypoints(rng)
    mom, pat = patches_and_moments_ref(
        torch.from_numpy(img), torch.from_numpy(blur), torch.from_numpy(yx),
        torch.from_numpy(torb.MOMENT_W_NP),
    )
    raw_x = np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    pat_x = np.asarray(jorb.extract_patches(jnp.asarray(blur), jnp.asarray(yx)))
    mom_x = raw_x.reshape(len(yx), -1) @ np.asarray(jorb._MOMENT_W)
    np.testing.assert_array_equal(pat.numpy(), pat_x)
    tol = 1e-5 * _moment_scale(raw_x)
    assert (np.abs(mom.numpy() - mom_x) <= tol).all()

    mom_p, pat_p = patches_and_moments_pallas(
        jnp.asarray(img), jnp.asarray(blur), jnp.asarray(yx), jorb.moment_weights32(), interpret=True
    )
    np.testing.assert_array_equal(pat.numpy(), np.asarray(pat_p)[:, :31, :31])
    assert (np.abs(mom.numpy() - np.asarray(mom_p)) <= tol).all()


def test_patches_clamp_like_dynamic_slice(jnp):
    """Grid padding slots can lie past the image; the JAX window start is
    clamped by dynamic_slice and the port reproduces it exactly."""
    from visual_slam_tpu.ops import orb as jorb

    rng = np.random.default_rng(12)
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    yx = np.array([[40, 50], [43, 55], [45, 2], [-1, 3], [0, 51]], np.int32)
    ref = np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    np.testing.assert_array_equal(torb.extract_patches(torch.from_numpy(img), torch.from_numpy(yx)).numpy(), ref)


def _pyramid_fixture(rng, sizes=((120, 160), (100, 133), (83, 111), (69, 92)), counts=(37, 0, 21, 13)):
    """Levels of different sizes with their keypoints: one level without
    any, counts that are not a multiple of the kernel's 4 keypoints a block,
    and centres on the corners, at -1 and at H / W (the grid's padding
    slots past the image)."""
    raws, blurs, yxs = [], [], []
    for (H, W), k in zip(sizes, counts):
        img, blur, yx = _image_and_keypoints(rng, H=H, W=W, K=max(k, 6))
        yx[4:6] = [[-1, W], [H, -1]]
        raws.append(img)
        blurs.append(blur)
        yxs.append(yx[:k])
    return raws, blurs, yxs


def test_patches_moments_levels_ref_matches_jax(jnp):
    """The multi-level plain version is the per-level calls concatenated
    level-major, and equals the JAX package's XLA path per level (patches
    exact, moments within 1e-5 of sum |w * p|); on CPU tensors the wrapper
    takes it and launches nothing."""
    from visual_slam_tpu.ops import orb as jorb

    rng = np.random.default_rng(28)
    raws, blurs, yxs = _pyramid_fixture(rng)
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    w = torch.from_numpy(torb.MOMENT_W_NP)
    mom, pat = patches_and_moments_levels_ref(t(raws), t(blurs), t(yxs), w)
    assert mom.shape == (71, 2) and pat.shape == (71, 31, 31)
    per = [patches_and_moments_ref(r, b, yx, w) for r, b, yx in zip(t(raws), t(blurs), t(yxs))]
    assert torch.equal(mom, torch.cat([m for m, _ in per])) and torch.equal(pat, torch.cat([p for _, p in per]))
    k0 = 0
    for raw, blur, yx in zip(raws, blurs, yxs):
        k = len(yx)
        if k:
            raw_x = np.asarray(jorb.extract_patches(jnp.asarray(raw), jnp.asarray(yx)))
            pat_x = np.asarray(jorb.extract_patches(jnp.asarray(blur), jnp.asarray(yx)))
            mom_x = raw_x.reshape(k, -1) @ np.asarray(jorb._MOMENT_W)
            np.testing.assert_array_equal(pat[k0:k0 + k].numpy(), pat_x)
            assert (np.abs(mom[k0:k0 + k].numpy() - mom_x) <= 1e-5 * _moment_scale(raw_x)).all()
        k0 += k
    n = patches_and_moments_levels.launches
    got = patches_and_moments_levels(t(raws), t(blurs), t(yxs), w)
    assert torch.equal(got[0], mom) and torch.equal(got[1], pat) and patches_and_moments_levels.launches == n


@pytest.mark.cuda
def test_patches_moments_kernel_matches_ref(cuda):
    """All four levels of a main-path frame size in one launch (643, 537,
    447 and 373 keypoints, as at 2000 features), then the edge fixture: a
    level without keypoints, counts off the block's multiple, centres at -1
    and H / W. Patches exact, moments within 1e-5 of sum |w * p|."""
    rng = np.random.default_rng(13)
    w = torch.from_numpy(torb.MOMENT_W_NP).to(cuda)
    big = [_image_and_keypoints(rng, H=h, W=wd, K=k)
           for (h, wd), k in zip(((376, 1240), (313, 1033), (261, 861), (218, 718)), (643, 537, 447, 373))]
    for raws, blurs, yxs in (list(zip(*big)), _pyramid_fixture(rng)):
        args = [[torch.from_numpy(a).to(cuda) for a in xs] for xs in (raws, blurs, yxs)]
        before = patches_and_moments_levels.launches
        mom, pat = patches_and_moments_levels(*args, w)
        torch.cuda.synchronize()
        assert patches_and_moments_levels.launches == before + 1
        mom_r, pat_r = patches_and_moments_levels_ref(*args, w)
        assert torch.equal(pat, pat_r)
        raw_p = torch.cat([torb.extract_patches(r, yx) for r, yx in zip(args[0], args[2])])
        tol = 1e-5 * _moment_scale(raw_p.cpu().numpy())
        assert (np.abs((mom - mom_r).cpu().numpy()) <= tol).all()


@pytest.mark.cuda
def test_patches_moments_kernel_rejects_bad_input(cuda):
    img = torch.zeros((20, 30), device=cuda)
    with pytest.raises(ValueError):
        patches_and_moments_levels([img], [img], [torch.zeros((4, 2), dtype=torch.int64, device=cuda)], img)
    with pytest.raises(ValueError):
        patches_and_moments_levels([img], [img[:10]], [torch.zeros((4, 2), dtype=torch.int32, device=cuda)], img)


# --- K2: Hamming top-2 -------------------------------------------------------


def _match_fixture(rng, k1=300, k2=257):
    d1 = _packed(rng, k1)
    d2 = _packed(rng, k2)
    d1[10:40] = d2[5:35]  # exact matches
    d1[40:50] = d1[10:20]  # two queries share a descriptor: column-argmin ties
    d2[100:110] = d2[5:15]  # two train columns share one: row ties and second == best
    v1 = rng.random(k1) > 0.1
    v2 = rng.random(k2) > 0.1
    v2[200:] = False  # some columns with no valid entry at all
    return d1, d2, v1, v2


def test_hamming_top2_ref_matches_jax(jnp):
    """Plain K2 against match_nn(distance_matrix) (XLA) and the Pallas
    kernel in interpret mode: exact, with planted distance ties. The column
    argmin is compared where the column has a valid entry."""
    from visual_slam_tpu.ops import matching as jm
    from visual_slam_tpu.ops.orb import unpack_bits
    from visual_slam_tpu.ops.pallas_kernels import hamming_top2

    rng = np.random.default_rng(14)
    d1, d2, v1, v2 = _match_fixture(rng)
    best, second, arg, colarg = mk.hamming_top2_ref(
        _i32(d1), _i32(d2), torch.from_numpy(v1), torch.from_numpy(v2)
    )
    dist = jm.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    b_x, s_x, a_x = (np.asarray(x) for x in jm.min2(dist))
    np.testing.assert_array_equal(best.numpy(), b_x)
    np.testing.assert_array_equal(second.numpy(), s_x)
    np.testing.assert_array_equal(arg.numpy(), a_x)
    col_ok = np.asarray(jnp.min(dist, axis=0)) < mk.BIG * 0.5
    np.testing.assert_array_equal(colarg.numpy()[col_ok], np.asarray(jnp.argmin(dist, axis=0))[col_ok])
    np.testing.assert_array_equal(colarg.numpy()[~col_ok], 0)

    b1, b2 = unpack_bits(jnp.asarray(d1)), unpack_bits(jnp.asarray(d2))
    pb, ps, pa, pc = hamming_top2(
        b1, b1.astype(jnp.float32).sum(-1), jnp.asarray(v1),
        b2, b2.astype(jnp.float32).sum(-1), jnp.asarray(v2), interpret=True,
    )
    np.testing.assert_array_equal(best.numpy(), np.asarray(pb))
    np.testing.assert_array_equal(second.numpy(), np.asarray(ps))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(colarg.numpy()[col_ok], np.asarray(pc)[col_ok])


@pytest.mark.cuda
def test_hamming_top2_kernel_matches_ref(cuda):
    rng = np.random.default_rng(15)
    d1, d2, v1, v2 = _match_fixture(rng, 2000, 2000)
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    before = mk.hamming_top2.launches
    out = mk.hamming_top2(*args)
    torch.cuda.synchronize()
    assert mk.hamming_top2.launches == before + 1
    for a, b in zip(out, mk.hamming_top2_ref(*args)):
        assert torch.equal(a, b)


def _tile_fixture(rng, k1, k2):
    """Random descriptors with ties on both sides of the kernel's 64-wide
    tile edges: train columns 63 and 64 (and 10 and 70) share a descriptor,
    so do query rows 63 and 64 (and 5 and 69), and some queries copy train
    columns next to them; about a tenth of rows and columns invalid."""
    d1, d2 = _packed(rng, k1), _packed(rng, k2)
    for a, b in ((63, 64), (10, 70)):
        if b < k2:
            d2[b] = d2[a]
    for a, b in ((63, 64), (5, 69)):
        if b < k1:
            d1[b] = d1[a]
    n = min(k1, k2)
    d1[: n // 2] = d2[: n // 2] ^ (rng.random((n // 2, 8)) < 0.05).astype(np.uint32)
    if k1 > 64 and k2 > 70:
        d1[20] = d2[70]  # a query whose exact match has an equal twin in another tile (10)
    return d1, d2, rng.random(k1) > 0.1, rng.random(k2) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2", [(1, 1), (1, 2000), (2000, 1), (31, 65), (65, 31), (65, 2000), (2000, 65),
                                   (2000, 2000)])
def test_hamming_top2_kernel_tile_edges(cuda, k1, k2):
    """Sizes that cross the 64 x 64 tile edges, K1 != K2, and row and column
    ties that straddle a tile boundary: exact against the plain version."""
    rng = np.random.default_rng(k1 * 7 + k2)
    d1, d2, v1, v2 = _tile_fixture(rng, k1, k2)
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    out = mk.hamming_top2(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, mk.hamming_top2_ref(*args)):
        assert torch.equal(a, b)


def _wide_fixture(rng, k1, k2):
    """``_tile_fixture`` at a train block past 5800 rows (the 13-bit column
    of the old 32-bit row partial ended at 8191): the last column ties
    column 1 (argbest stays 1, second == best), column k2 - 2 is query 3's
    exact match, and where k2 > 8192 column 8192 is query 4's."""
    d1, d2, v1, v2 = _tile_fixture(rng, k1, k2)
    d2[k2 - 1] = d2[1]
    d1[3] = d2[k2 - 2]
    v1[3] = v2[1] = v2[k2 - 2] = v2[k2 - 1] = True
    if k2 > 8192 and k1 > 4:
        d1[4] = d2[8192]
        v1[4] = v2[8192] = True
    return d1, d2, v1, v2


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2", [(2000, 5801), (2000, 8192), (64, 65536)])
def test_hamming_top2_kernel_wide_train_blocks(cuda, k1, k2):
    """K2 past the 5800 train rows it used to take, up to 65536: exact
    against the plain version, ties across tile edges included."""
    rng = np.random.default_rng(k2)
    d1, d2, v1, v2 = _wide_fixture(rng, k1, k2)
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    out = mk.hamming_top2(*args)
    torch.cuda.synchronize()
    ref = mk.hamming_top2_ref(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int(out[2][3]) == k2 - 2 and float(out[0][3]) == 0.0


@pytest.mark.cuda
def test_hamming_top2_batched_kernel_wide_train_blocks(cuda):
    """K4 with C = 8 candidate blocks of 8192 rows, one of them padding:
    exact against the plain version."""
    rng = np.random.default_rng(8)
    d1, d2, v1, v2 = _wide_fixture(rng, 2000, 8192)
    blocks = np.stack([d2] + [_packed(rng, 8192) for _ in range(7)])
    valid = np.stack([v2] + [rng.random(8192) > 0.1 for _ in range(6)] + [np.zeros(8192, bool)])
    args = [_i32(d1).to(cuda), _i32(blocks).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(valid).to(cuda)]
    out = mk.hamming_top2_batched(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, mk.hamming_top2_batched_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hamming_top2_kernel_all_invalid(cuda):
    """All-invalid rows, columns and whole candidates, beside real ones:
    BIG/BIG/0 and column argmin 0 exactly where the plain version has them."""
    rng = np.random.default_rng(27)
    d1, d2, v1, v2 = _tile_fixture(rng, 130, 200)
    v1[64:128] = False  # a whole query tile
    v2[:64] = False  # a whole train tile
    d2 = np.stack([d2, d2, _packed(rng, 200)])
    v2 = np.stack([v2, np.zeros(200, bool), rng.random(200) > 0.5])
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    out = mk.hamming_top2_batched(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, mk.hamming_top2_batched_ref(*args)):
        assert torch.equal(a, b)
    assert (out[0][1] == mk.BIG).all() and (out[2][1] == 0).all() and (out[3][1] == 0).all()
    none = torch.zeros(130, dtype=torch.bool, device=cuda)
    out = mk.hamming_top2(args[0], args[1][0], none, args[3][0])  # no valid query at all
    assert (out[0] == mk.BIG).all() and (out[1] == mk.BIG).all() and (out[2] == 0).all() and (out[3] == 0).all()


# --- K4: Hamming top-2 against C candidate blocks ----------------------------


def _batched_fixture(rng, k1=192, k2=160, C=3):
    """test_pallas_batched_equals_xla's shapes: C random candidate blocks
    with planted near-duplicates, row and column ties and ~10% invalid
    rows, plus one all-invalid block (loop closing's padding)."""
    d1 = _packed(rng, k1)
    v1 = rng.random(k1) > 0.1
    d2 = np.stack([_packed(rng, k2) for _ in range(C + 1)])
    v2 = rng.random((C + 1, k2)) > 0.1
    for c in range(C):
        near = rng.choice(k1, 60, replace=False)
        d2[c, :60] = d1[near] ^ (rng.random((60, 8)) < 0.03).astype(np.uint32)
        d2[c, 80:90] = d2[c, :10]  # train ties: argbest to the lower column, second == best
    d1[100:110] = d1[near[10:20]]  # query ties: the column argmin takes the lower row
    v2[C] = False
    angles = (rng.uniform(-np.pi, np.pi, k1).astype(np.float32),
              rng.uniform(-np.pi, np.pi, (C + 1, k2)).astype(np.float32))
    return d1, v1, d2, v2, angles


def test_hamming_top2_batched_ref_matches_jax(jnp):
    """Plain K4 against the per-candidate XLA path (min2 and argmin of
    hamming_distance_matrix, as lax.map over match_descriptors computes
    them) and hamming_top2_batched in interpret mode: exact everywhere
    against XLA, including the all-invalid block (best = second = BIG,
    argbest 0, col_argmin 0); against the Pallas kernel exact, with the
    column argmin compared where the column has a valid entry."""
    from visual_slam_tpu.ops import matching as jm
    from visual_slam_tpu.ops.orb import unpack_bits
    from visual_slam_tpu.ops.pallas_kernels import hamming_top2_batched

    rng = np.random.default_rng(19)
    d1, v1, d2, v2, _ = _batched_fixture(rng)
    best, second, arg, colarg = mk.hamming_top2_batched(
        _i32(d1), _i32(d2), torch.from_numpy(v1), torch.from_numpy(v2)
    )
    assert best.shape == (4, 192) and colarg.shape == (4, 160) and arg.dtype == colarg.dtype == torch.int32
    for c in range(4):
        dist = jm.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2[c]), jnp.asarray(v1), jnp.asarray(v2[c]))
        b_x, s_x, a_x = (np.asarray(x) for x in jm.min2(dist))
        np.testing.assert_array_equal(best[c].numpy(), b_x)
        np.testing.assert_array_equal(second[c].numpy(), s_x)
        np.testing.assert_array_equal(arg[c].numpy(), a_x)
        np.testing.assert_array_equal(colarg[c].numpy(), np.asarray(jnp.argmin(dist, axis=0)))
    assert (best[3] == mk.BIG).all() and (second[3] == mk.BIG).all()
    assert (arg[3] == 0).all() and (colarg[3] == 0).all()

    b1, b2 = unpack_bits(jnp.asarray(d1)), unpack_bits(jnp.asarray(d2))
    pb, ps, pa, pc = hamming_top2_batched(
        b1, b1.astype(jnp.float32).sum(-1), jnp.asarray(v1),
        b2, b2.astype(jnp.float32).sum(-1), jnp.asarray(v2), interpret=True,
    )
    np.testing.assert_array_equal(best.numpy(), np.asarray(pb))
    np.testing.assert_array_equal(second.numpy(), np.asarray(ps))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(pa))
    col_ok = v2 & v1.any()  # columns with a valid entry
    np.testing.assert_array_equal(colarg.numpy()[col_ok], np.asarray(pc)[col_ok])


def test_match_descriptors_batched_matches_jax(jnp):
    """The batched matcher (K4, ratio test, cross-check, unique_train,
    orientation filter per candidate) against JAX's CPU path, lax.map over
    match_descriptors: train_idx, valid and n_matches exact."""
    from visual_slam_tpu.ops import matching as jm
    from visual_slam_tpu_torch.ops.matching import match_descriptors_batched

    rng = np.random.default_rng(23)
    d1, v1, d2, v2, (a1, a2) = _batched_fixture(rng)
    a2[:, :60] = a1[:60][None] - 0.3  # a dominant rotation bin among the planted matches
    ref = jm.match_descriptors_batched(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(a1), jnp.asarray(a2)
    )
    got = match_descriptors_batched(
        _i32(d1), _i32(d2), torch.from_numpy(v1), torch.from_numpy(v2), torch.from_numpy(a1), torch.from_numpy(a2)
    )
    n = np.asarray(ref["n_matches"])
    assert n[:3].min() > 5 and n[3] == 0
    np.testing.assert_array_equal(got["n_matches"].numpy(), n)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["train_idx"].numpy(), np.asarray(ref["train_idx"]))
    np.testing.assert_array_equal(got["distance"].numpy(), np.asarray(ref["distance"]))


@pytest.mark.cuda
def test_hamming_top2_batched_kernel_matches_ref(cuda):
    """Loop closing's shape: a 2000-row query against 8 real and 56
    all-invalid 2000-column blocks."""
    rng = np.random.default_rng(24)
    d1, v1, d2, v2, _ = _batched_fixture(rng, 2000, 2000, 8)
    d2 = np.concatenate([d2, np.repeat(d2[:1], 55, 0)])
    v2 = np.concatenate([v2, np.zeros((55, 2000), bool)])
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    before = mk.hamming_top2_batched.launches
    out = mk.hamming_top2_batched(*args)
    torch.cuda.synchronize()
    assert mk.hamming_top2_batched.launches == before + 1
    for a, b in zip(out, mk.hamming_top2_batched_ref(*args)):
        assert torch.equal(a, b)


# --- K5: 32x32 window gather -------------------------------------------------


def test_extract_patches32_ref_matches_jax(jnp):
    """Plain K5 against extract_patches32_pallas in interpret mode, exact,
    at 120x160 with keypoints on all four borders and corners; its top-left
    31x31 is orb.extract_patches' window."""
    from visual_slam_tpu.ops import orb as jorb
    from visual_slam_tpu.ops.pallas_patches import extract_patches32_pallas

    rng = np.random.default_rng(25)
    img, _, yx = _image_and_keypoints(rng, K=48)
    yx[4:12] = [[0, 50], [119, 70], [60, 0], [30, 159], [1, 1], [118, 158], [0, 80], [100, 159]]
    got = extract_patches32_ref(torch.from_numpy(img), torch.from_numpy(yx)).numpy()
    assert got.shape == (48, 32, 32)
    np.testing.assert_array_equal(got, np.asarray(extract_patches32_pallas(jnp.asarray(img), jnp.asarray(yx), interpret=True)))
    np.testing.assert_array_equal(got[:, :31, :31], np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(yx))))


@pytest.mark.cuda
def test_extract_patches32_kernel_matches_ref(cuda):
    rng = np.random.default_rng(26)
    img, _, yx = _image_and_keypoints(rng, H=376, W=1240, K=2000)
    args = [torch.from_numpy(img).to(cuda), torch.from_numpy(yx).to(cuda)]
    before = extract_patches32.launches
    out = extract_patches32(*args)
    torch.cuda.synchronize()
    assert extract_patches32.launches == before + 1
    assert torch.equal(out, extract_patches32_ref(*args))


# --- K3: guided top-2 --------------------------------------------------------


def _guided_fixture(rng, M=300, Kp=200, W=320.0, H=240.0, F=260.0, plant=120):
    """test_pallas_guided_equals_xla's fixture: random arena, distance ties
    between landmark pairs, keypoints planted near their landmarks'
    projections with copied descriptors."""
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
    lm_pos = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(4, 30, M)], 1).astype(np.float32)
    lm_desc = _packed(rng, M)
    lm_desc[1:60:2] = lm_desc[0:60:2]
    lm_valid = rng.random(M) > 0.1
    kp_xy = np.stack([rng.uniform(0, W, Kp), rng.uniform(0, H, Kp)], 1).astype(np.float32)
    kp_desc = _packed(rng, Kp)
    uv = lm_pos[:, :2] / lm_pos[:, 2:3] * F + np.array([W / 2, H / 2], np.float32)
    for j in range(0, min(plant, M), 3):
        kp_desc[j % Kp] = lm_desc[j]
        kp_xy[j % Kp] = uv[j] + rng.uniform(-5, 5, 2)
    kp_valid = rng.random(Kp) > 0.1
    return K, lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid


def test_guided_top2_ref_matches_jax(jnp):
    """Plain K3 (through the port's guided_match) against the JAX XLA path
    and guided_top2_pallas in interpret mode: lm_idx/valid exact, including
    distance ties broken toward the lower landmark."""
    from visual_slam_tpu.ops.guided_matching import guided_match as j_guided
    from visual_slam_tpu.ops.orb import unpack_bits
    from visual_slam_tpu.ops.pallas_kernels import guided_top2_pallas
    from visual_slam_tpu.ops.projection import project_points as j_project
    from visual_slam_tpu_torch.ops.guided_matching import guided_match

    rng = np.random.default_rng(16)
    K, lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid = _guided_fixture(rng)
    W, H, radius = 320.0, 240.0, 12.0
    T = np.eye(4, dtype=np.float32)
    ref = j_guided(jnp.asarray(lm_pos), jnp.asarray(lm_desc), jnp.asarray(lm_valid), jnp.asarray(T),
                   jnp.asarray(K), jnp.asarray(kp_xy), jnp.asarray(kp_desc), jnp.asarray(kp_valid),
                   W, H, radius_px=radius)
    got = guided_match(torch.from_numpy(lm_pos), _i32(lm_desc), torch.from_numpy(lm_valid),
                       torch.from_numpy(T), torch.from_numpy(K), torch.from_numpy(kp_xy), _i32(kp_desc),
                       torch.from_numpy(kp_valid), W, H, radius_px=torch.tensor(radius))
    sel = np.asarray(ref["valid"])
    assert sel.sum() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), sel)
    np.testing.assert_array_equal(got["lm_idx"].numpy()[sel], np.asarray(ref["lm_idx"])[sel])
    np.testing.assert_array_equal(got["pts3d"].numpy()[sel], np.asarray(ref["pts3d"])[sel])

    uv, z = j_project(jnp.asarray(K), jnp.asarray(T), jnp.asarray(lm_pos))
    vis = jnp.asarray(lm_valid) & (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    b1, b2 = unpack_bits(jnp.asarray(lm_desc)), unpack_bits(jnp.asarray(kp_desc))
    p_idx, p_valid = guided_top2_pallas(
        b1, b1.astype(jnp.float32).sum(-1), vis, uv, b2, b2.astype(jnp.float32).sum(-1),
        jnp.asarray(kp_valid), jnp.asarray(kp_xy), jnp.float32(radius), interpret=True,
    )
    lm_idx, valid = mk.guided_top2_ref(
        _i32(lm_desc), torch.from_numpy(np.array(vis)), torch.from_numpy(np.array(uv)),
        _i32(kp_desc), torch.from_numpy(kp_valid), torch.from_numpy(kp_xy), torch.tensor(radius * radius),
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(p_valid))
    np.testing.assert_array_equal(lm_idx.numpy()[valid.numpy()], np.asarray(p_idx)[valid.numpy()])


@pytest.mark.cuda
def test_guided_top2_kernel_matches_ref(cuda):
    rng = np.random.default_rng(17)
    K, lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid = _guided_fixture(rng, M=4096, Kp=2000, W=1240.0, H=376.0, F=718.856, plant=3000)
    uv = lm_pos[:, :2] / lm_pos[:, 2:3] * 718.856 + np.array([620.0, 188.0], np.float32)
    args = [_i32(lm_desc), torch.from_numpy(lm_valid), torch.from_numpy(uv.astype(np.float32)),
            _i32(kp_desc), torch.from_numpy(kp_valid), torch.from_numpy(kp_xy)]
    args = [a.to(cuda) for a in args] + [torch.tensor(12.0 * 12.0, device=cuda)]
    before = mk.guided_top2.launches
    lm_idx, valid = mk.guided_top2(*args)
    torch.cuda.synchronize()
    assert mk.guided_top2.launches == before + 1
    r_idx, r_valid = mk.guided_top2_ref(*args)
    assert int(r_valid.sum()) > 200
    assert torch.equal(valid, r_valid)
    assert torch.equal(lm_idx, r_idx)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kp", [(4096, 5000), (61, 20), (100, 2049)])
def test_guided_top2_kernel_chunks_and_edges(cuda, M, Kp):
    """Keypoints past one 2048-wide shared-memory chunk, fewer keypoints
    than lanes, and landmark counts that are not a multiple of the block's
    16: exact against the plain version, ties included."""
    rng = np.random.default_rng(M + Kp)
    K, lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid = _guided_fixture(
        rng, M=M, Kp=Kp, W=1240.0, H=376.0, F=718.856, plant=min(M, 3 * Kp))
    kp_desc[Kp // 2:] = kp_desc[: Kp - Kp // 2]  # keypoint ties, across chunks where Kp > 2048
    kp_xy[Kp // 2:] = kp_xy[: Kp - Kp // 2]
    uv = lm_pos[:, :2] / lm_pos[:, 2:3] * 718.856 + np.array([620.0, 188.0], np.float32)
    args = [_i32(lm_desc), torch.from_numpy(lm_valid), torch.from_numpy(uv.astype(np.float32)),
            _i32(kp_desc), torch.from_numpy(kp_valid), torch.from_numpy(kp_xy)]
    args = [a.to(cuda) for a in args] + [torch.tensor(30.0 * 30.0, device=cuda)]
    lm_idx, valid = mk.guided_top2(*args)
    torch.cuda.synchronize()
    r_idx, r_valid = mk.guided_top2_ref(*args)
    assert torch.equal(valid, r_valid)
    assert torch.equal(lm_idx, r_idx)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    rng = np.random.default_rng(18)
    d1, d2, v1, v2 = _match_fixture(rng, 128, 112)
    n = mk.hamming_top2.launches
    out = mk.hamming_top2(_i32(d1), _i32(d2), torch.from_numpy(v1), torch.from_numpy(v2))
    ref = mk.hamming_top2_ref(_i32(d1), _i32(d2), torch.from_numpy(v1), torch.from_numpy(v2))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert mk.hamming_top2.launches == n


@pytest.mark.cuda
def test_track_step_cuda_matches_cpu(cuda):
    """The whole step on the card (kernels) against the same step on the
    CPU (plain versions), from the same state: both within (R 0.01, t 0.06)
    of ground truth and of each other on frames 1-2, and each step
    launches K1, K2 and K3 once each."""
    from render import camera_path, make_world, render, render_with_depth
    from visual_slam_tpu_torch import pipeline

    rng = np.random.default_rng(3)
    world = make_world(rng)
    Ts = camera_path(3, step=0.25)
    W, H, F, NF, M = 320, 240, 260.0, 256, 512
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
    frames = [render(world, T, K, W, H) for T in Ts]
    kw = dict(num_features=NF, fast_threshold=12.0, n_levels=2, grid=4, pnp_hypotheses=64,
              local_map=True, width=W, height=H)
    cpu_step = pipeline.make_track_step(K, device="cpu", **kw)
    gpu_step = pipeline.make_track_step(K, device=cuda, **kw)
    feats = cpu_step.detect(torch.from_numpy(frames[0]))
    xy, valid = feats.xy.numpy(), feats.valid.numpy()
    _, zbuf = render_with_depth(world, Ts[0], K, W, H)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and zbuf[v, u] > 0.5:
            lm[i] = (np.linalg.inv(K) @ np.array([xy[i, 0], xy[i, 1], 1.0])) * zbuf[v, u]
            has[i] = True
    lm_pos, lm_desc, lm_valid = np.zeros((M, 3), np.float32), np.zeros((M, 8), np.int32), np.zeros(M, bool)
    lm_pos[:NF], lm_desc[:NF], lm_valid[:NF] = lm, feats.desc.numpy(), has

    def state(device):
        s = pipeline.init_track_state(feats, lm, has, np.eye(4), local_map_size=M, device=device)
        return pipeline.set_local_map(s, lm_pos, lm_desc, lm_valid)

    s_cpu, s_gpu = state("cpu"), state(cuda)
    counts = (patches_and_moments_levels.launches, mk.hamming_top2.launches, mk.guided_top2.launches)
    for i in (1, 2):
        s_cpu, o_cpu = cpu_step(s_cpu, torch.from_numpy(frames[i]))
        s_gpu, o_gpu = gpu_step(s_gpu, torch.from_numpy(frames[i]).to(cuda))
        T_c, T_g = o_cpu.T_w2c.numpy(), o_gpu.T_w2c.cpu().numpy()
        assert int(o_gpu.n_inliers) >= 20
        for T in (T_c, T_g):
            np.testing.assert_allclose(T[:3, :3], Ts[i][:3, :3], atol=0.01)
            np.testing.assert_allclose(T[:3, 3], Ts[i][:3, 3], atol=0.06)
        np.testing.assert_allclose(T_g[:3, :3], T_c[:3, :3], atol=0.01)
        np.testing.assert_allclose(T_g[:3, 3], T_c[:3, 3], atol=0.06)
    assert (patches_and_moments_levels.launches - counts[0], mk.hamming_top2.launches - counts[1],
            mk.guided_top2.launches - counts[2]) == (2, 2, 2)


# --- batched K1, K2, K3 (the batched VO step) on the card --------------------


def _stacked(cuda, frames):
    """B frames' levels, each a (raw, blur, yx) triple -> (raws, blurs, yxs),
    each a list over the levels of the B frames' arrays stacked on a leading
    B."""
    per_level = [[torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*lv)] for lv in zip(*frames)]
    return [list(x) for x in zip(*per_level)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main_path_b4", "past_16_entries_b8"])
def test_patches_moments_batched_kernel_matches_ref(cuda, case):
    """B frames of every level in one launch: four main-path levels (643,
    537, 447 and 373 keypoints) at B = 4, and the edge fixture (a level
    without keypoints, centres at -1 and H / W) at B = 8, 32 level entries
    where the one-frame table holds 16; frame 0's keypoints all lie on
    padding slots past the image. Patches exact, moments within 1e-5 of sum
    |w * p|."""
    rng = np.random.default_rng(41 if case == "main_path_b4" else 42)
    w = torch.from_numpy(torb.MOMENT_W_NP).to(cuda)
    B = 4 if case == "main_path_b4" else 8
    shapes = ((376, 1240), (313, 1033), (261, 861), (218, 718))
    frames = []
    for b in range(B):
        if case == "main_path_b4":
            lv = [_image_and_keypoints(rng, H=h, W=wd, K=k) for (h, wd), k in zip(shapes, (643, 537, 447, 373))]
            frames.append([(r, bl, yx) for r, bl, yx in lv])
        else:
            raws, blurs, yxs = _pyramid_fixture(rng)
            frames.append(list(zip(raws, blurs, yxs)))
    for lvl in frames[0]:  # frame 0: padding slots only
        Hl, Wl = lvl[0].shape
        lvl[2][:] = np.array([[-1, Wl], [Hl, -1]], np.int32)[np.arange(len(lvl[2])) % 2]
    raws, blurs, yxs = _stacked(cuda, frames)
    before = patches_and_moments_batched.launches
    mom, pat = patches_and_moments_batched(raws, blurs, yxs, w)
    torch.cuda.synchronize()
    assert patches_and_moments_batched.launches == before + 1
    mom_r, pat_r = patches_and_moments_batched_ref(raws, blurs, yxs, w)
    assert pat.shape == (B, sum(int(y.shape[1]) for y in yxs), 31, 31)
    assert torch.equal(pat, pat_r)
    raw_p = torch.stack([torch.cat([torb.extract_patches(r[b], y[b]) for r, y in zip(raws, yxs)]) for b in range(B)])
    tol = 1e-5 * _moment_scale(raw_p.reshape(-1, 31, 31).cpu().numpy()).reshape(B, -1, 2)
    assert (np.abs((mom - mom_r).cpu().numpy()) <= tol).all()


@pytest.mark.cuda
def test_patches_moments_batched_b1_equals_unbatched(cuda):
    """B = 1 is the one-frame kernel: moments and patches bit for bit."""
    rng = np.random.default_rng(43)
    w = torch.from_numpy(torb.MOMENT_W_NP).to(cuda)
    raws, blurs, yxs = [[torch.from_numpy(a).to(cuda) for a in xs] for xs in _pyramid_fixture(rng)]
    one = patches_and_moments_levels(raws, blurs, yxs, w)
    batched = patches_and_moments_batched([r[None] for r in raws], [b[None] for b in blurs], [y[None] for y in yxs], w)
    torch.cuda.synchronize()
    assert torch.equal(batched[0][0], one[0]) and torch.equal(batched[1][0], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k1,k2", [(2000, 2000), (130, 1), (65, 200)])
def test_hamming_top2_paired_kernel_matches_ref(cuda, k1, k2):
    """B = 4 query blocks, each against its own train block, in one launch
    pair: the main path's 2000 x 2000, one train column per sequence (no
    second: +inf) and sizes off the tile edges; sequence 1 has no valid
    query. Exact against the plain version, ties included."""
    rng = np.random.default_rng(k1 + 3 * k2)
    fx = [_tile_fixture(rng, k1, k2) for _ in range(4)]
    d1, d2, v1, v2 = (np.stack(a) for a in zip(*fx))
    v1[1] = False
    args = [_i32(d1).to(cuda), _i32(d2).to(cuda), torch.from_numpy(v1).to(cuda), torch.from_numpy(v2).to(cuda)]
    before = mk.hamming_top2_paired.launches
    out = mk.hamming_top2_paired(*args)
    torch.cuda.synchronize()
    assert mk.hamming_top2_paired.launches == before + 1
    ref = mk.hamming_top2_paired_ref(*args)
    for a, b in zip(out, ref):
        assert a.shape[0] == 4 and torch.equal(a, b)
    assert (out[0][1] == mk.BIG).all() and (out[2][1] == 0).all()
    if k2 == 1:
        assert torch.isinf(out[1][0]).all()
    one = mk.hamming_top2(*[a[2] for a in args])
    paired = mk.hamming_top2_paired(*[a[2:3] for a in args])
    assert all(torch.equal(p[0], o) for p, o in zip(paired, one))  # B = 1 is the one-pair kernel


@pytest.mark.cuda
def test_guided_top2_batched_kernel_matches_ref(cuda):
    """B = 4 arenas of 4096 against 2000 keypoints each, each with its own
    radius (12 to 48 px), in one launch pair; sequence 2 has no valid
    keypoint. Exact against the plain version, ties included, and B = 1 is
    the one-arena kernel."""
    rng = np.random.default_rng(44)
    seqs = []
    for _ in range(4):
        K, lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid = _guided_fixture(
            rng, M=4096, Kp=2000, W=1240.0, H=376.0, F=718.856, plant=3000)
        uv = (lm_pos[:, :2] / lm_pos[:, 2:3] * 718.856 + np.array([620.0, 188.0], np.float32)).astype(np.float32)
        seqs.append((lm_desc.view(np.int32), lm_valid, uv, kp_desc.view(np.int32), kp_valid, kp_xy))
    args = [torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*seqs)]
    args[4][2] = False
    r2 = torch.tensor([12.0, 25.0, 30.0, 48.0], device=cuda) ** 2
    before = mk.guided_top2_batched.launches
    lm_idx, valid = mk.guided_top2_batched(*args, r2)
    torch.cuda.synchronize()
    assert mk.guided_top2_batched.launches == before + 1
    r_idx, r_valid = mk.guided_top2_batched_ref(*args, r2)
    assert int(r_valid.sum()) > 800 and not bool(r_valid[2].any())
    assert torch.equal(valid, r_valid) and torch.equal(lm_idx, r_idx)
    one = mk.guided_top2(*[a[3] for a in args], r2[3])
    batched = mk.guided_top2_batched(*[a[3:] for a in args], r2[3:])
    assert torch.equal(batched[0][0], one[0]) and torch.equal(batched[1][0], one[1])
