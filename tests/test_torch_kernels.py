"""Kernels K1-K3 of the torch port: each plain version against the JAX
package (XLA path and Pallas interpret mode) on the CPU, and each CUDA
kernel against its plain version on the card (marked ``cuda``).

The JAX package is imported inside the tests that need it, so the card's
tests also run where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.ops import match_kernels as mk
from visual_slam_tpu_torch.ops import orb as torb
from visual_slam_tpu_torch.ops.patch_kernels import patches_and_moments, patches_and_moments_ref

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


@pytest.mark.cuda
def test_patches_moments_kernel_matches_ref(cuda):
    rng = np.random.default_rng(13)
    img, blur, yx = _image_and_keypoints(rng, H=376, W=1240, K=643)
    args = [torch.from_numpy(a).to(cuda) for a in (img, blur, yx)]
    w = torch.from_numpy(torb.MOMENT_W_NP).to(cuda)
    before = patches_and_moments.launches
    mom, pat = patches_and_moments(*args, w)
    torch.cuda.synchronize()
    assert patches_and_moments.launches == before + 1
    mom_r, pat_r = patches_and_moments_ref(*args, w)
    assert torch.equal(pat, pat_r)
    tol = 1e-5 * _moment_scale(torb.extract_patches(args[0], args[2]).cpu().numpy())
    assert (np.abs((mom - mom_r).cpu().numpy()) <= tol).all()


@pytest.mark.cuda
def test_patches_moments_kernel_rejects_bad_input(cuda):
    img = torch.zeros((20, 30), device=cuda)
    with pytest.raises(ValueError):
        patches_and_moments(img, img, torch.zeros((4, 2), dtype=torch.int64, device=cuda), img)


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
    launches K1 once per level and K2, K3 once."""
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
    cpu_step = pipeline.make_track_step(K, **kw)
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
    counts = (patches_and_moments.launches, mk.hamming_top2.launches, mk.guided_top2.launches)
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
    assert (patches_and_moments.launches - counts[0], mk.hamming_top2.launches - counts[1],
            mk.guided_top2.launches - counts[2]) == (4, 2, 2)
