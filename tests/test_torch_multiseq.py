"""The port's multi-sequence batched VO (``parallel.multiseq``, BASELINE
config 5) on the CPU at a small size: B = 3 sprite worlds at 320x240, 256
features, 2 levels, 64 hypotheses, a 512-slot arena.

What is bit-exact and what carries a tolerance, batched against B single
steps on the same inputs:
- detection: keypoints, responses, angles, octaves, sizes and validity
  exactly (pyramid, FAST, NMS, grid top-k and K1 compute each frame alone);
  descriptors on at least 99 % of the valid bits (ROADMAP's rule), not all:
  the BRIEF product is one matmul over the B * K_l rows of a level, and the
  CPU's sgemm sums a product of fewer than about 200 rows in another order
  than one of more, so a sample pair that ties within rounding flips a bit;
- matching (K2, filters) and guided matching (K3) on the same features and
  poses exactly; RANSAC draws from B generators the same sets as B single
  draws, exactly;
- poses: the batched 3x3 / 4x4 products and factorizations round otherwise
  than the single ones, and a flipped descriptor bit moves a match, so the
  poses are held to tests/test_torch_pipeline.py's (R 0.01, t 0.06), against
  the single steps, the JAX package's ``make_batched_vo`` and ground truth.

JAX is imported inside the tests that need it, so the ``cuda`` case also
runs where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_multiseq.py``.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import pipeline as tp
from visual_slam_tpu_torch.models import BatchedVO
from visual_slam_tpu_torch.ops import match_kernels as mk
from visual_slam_tpu_torch.ops import orb as torb
from visual_slam_tpu_torch.ops.batch import take_rows
from visual_slam_tpu_torch.ops.epipolar import _sample_minimal_sets
from visual_slam_tpu_torch.ops.guided_matching import guided_match
from visual_slam_tpu_torch.ops.matching import match_descriptors
from visual_slam_tpu_torch.ops.patch_kernels import (
    patches_and_moments_batched,
    patches_and_moments_batched_ref,
    patches_and_moments_levels,
    patches_and_moments_levels_ref,
)
from visual_slam_tpu_torch.ops.projection import normalize_points
from visual_slam_tpu_torch.parallel import make_batched_vo, make_mesh, shard_batch

from render import camera_path, make_world, render, render_with_depth

torch.set_num_threads(1)

B, NF, M = 3, 256, 512
W, H, F = 320, 240, 260.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
STEP_KW = dict(num_features=NF, fast_threshold=12.0, n_levels=2, grid=4, pnp_hypotheses=64, width=W, height=H)
R_ATOL, T_ATOL = 0.01, 0.06  # tests/test_pipeline.py's bounds on poses
# Worlds where the JAX package's own batched step stays within the pose
# bounds of ground truth on frames 1-2 (the tiny worlds are chaotic: at world
# seed 4 its local-map step leaves ground truth by 0.097 m on frame 1 with
# 166 inliers, at seed 8 by 0.087 m on frame 2 without the local map).
WORLD_SEEDS = (3, 6, 11)


class World(NamedTuple):
    Ts: np.ndarray
    frames: np.ndarray
    zbuf: np.ndarray


def make_worlds(n: int = B) -> list[World]:
    """tests/test_torch_pipeline.py's sprite world at ``WORLD_SEEDS``, 3
    frames of its forward-lateral path each."""
    out = []
    for seed in WORLD_SEEDS[:n]:
        world = make_world(np.random.default_rng(seed))
        Ts = camera_path(3, step=0.25)
        frames = np.stack([render(world, T, K, W, H) for T in Ts]).astype(np.float32)
        out.append(World(Ts, frames, render_with_depth(world, Ts[0], K, W, H)[1]))
    return out


def reference_block(world: World, xy: np.ndarray, valid: np.ndarray):
    """Frame-0 keypoints get landmarks from the z-buffer; the same landmarks
    fill the first slots of the arena. Returns (lm, has, arena (pos, valid))."""
    Kinv = np.linalg.inv(K)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= u < W and 0 <= v < H and world.zbuf[v, u] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * world.zbuf[v, u]
            has[i] = True
    lm_pos, lm_valid = np.zeros((M, 3), np.float32), np.zeros(M, bool)
    lm_pos[:NF], lm_valid[:NF] = lm, has
    return lm, has, lm_pos, lm_valid


def make_states(worlds, device, local_map: bool) -> list[tp.TrackState]:
    """One port state per world from the port's detect on frame 0 (CPU),
    RANSAC seed b for sequence b, on ``device``."""
    det = tp.make_track_step(K, device="cpu", **STEP_KW)
    states = []
    for b, w in enumerate(worlds):
        feats = det.detect(torch.from_numpy(w.frames[0]))
        lm, has, lm_pos, lm_valid = reference_block(w, feats.xy.numpy(), feats.valid.numpy())
        s = tp.init_track_state(feats, lm, has, np.eye(4), seed=b, local_map_size=M if local_map else 0, device=device)
        if local_map:
            lm_desc = np.zeros((M, 8), np.int32)
            lm_desc[:NF] = feats.desc.numpy()
            s = tp.set_local_map(s, lm_pos, lm_desc, lm_valid)
        states.append(s)
    return states


@pytest.fixture(scope="module")
def worlds():
    return make_worlds()


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    from visual_slam_tpu import pipeline as jp

    return jax, jp


def _assert_pose(T, T_ref):
    np.testing.assert_allclose(T[:3, :3], T_ref[:3, :3], atol=R_ATOL)
    np.testing.assert_allclose(T[:3, 3], T_ref[:3, 3], atol=T_ATOL)


def test_batched_detect_matches_single(worlds):
    """Every feature field but the descriptor bit for bit; the descriptors on
    >= 99 % of the valid bits (the module docstring says why not all)."""
    step = tp.make_track_step(K, device="cpu", **STEP_KW)
    imgs = torch.from_numpy(np.stack([w.frames[1] for w in worlds]))
    n = patches_and_moments_batched.launches
    fb = step.detect(imgs)
    assert fb.desc.shape == (B, NF, 8) and fb.xy.shape == (B, NF, 2)
    assert patches_and_moments_batched.launches == n  # CPU tensors: the plain version
    for b in range(B):
        f = step.detect(imgs[b])
        for name in ("xy", "response", "angle", "octave", "size", "valid"):
            assert torch.equal(getattr(f, name), getattr(fb, name)[b]), name
        v = f.valid
        same = torb.unpack_bits(f.desc[v]) == torb.unpack_bits(fb.desc[b][v])
        assert same.float().mean() >= 0.99


def test_batched_match_guided_and_ransac_stages_match_single(worlds):
    """On the same features, poses and sample indices, the batched K2 match
    (ratio, cross-check, unique-train, orientation) and the batched guided
    match (K3 with a radius per sequence) equal the single ones exactly; so
    do the RANSAC sets drawn from B generators. RANSAC-PnP fed the same sets
    gives poses within 1e-4 (batched small products round otherwise)."""
    step = tp.make_track_step(K, device="cpu", local_map=True, **STEP_KW)
    states = make_states(worlds, "cpu", local_map=True)
    feats = [step.detect(torch.from_numpy(w.frames[1])) for w in worlds]
    fb = type(feats[0])(*[torch.stack(x) for x in zip(*feats)])
    sb = tp.stack_track_states(states)
    mb = match_descriptors(fb.desc, sb.ref_feats.desc, fb.valid, sb.ref_feats.valid, fb.angle, sb.ref_feats.angle,
                           ratio=0.75, cross_check=True, use_orientation=True)
    T_pred = torch.from_numpy(np.stack([w.Ts[1] for w in worlds]).astype(np.float32))
    radius = torch.tensor([25.0, 40.0, 60.0])
    gb = guided_match(sb.lm_pos, sb.lm_desc, sb.lm_valid, T_pred, step.K, fb.xy, fb.desc, fb.valid, W, H,
                      radius_px=radius)
    gens = tuple(torch.Generator().manual_seed(10 + b) for b in range(B))
    idx_b = _sample_minimal_sets(gens, mb["valid"], 64, 6)
    for b, (f, s) in enumerate(zip(feats, states)):
        m = match_descriptors(f.desc, s.ref_feats.desc, f.valid, s.ref_feats.valid, f.angle, s.ref_feats.angle,
                              ratio=0.75, cross_check=True, use_orientation=True)
        for key in ("train_idx", "valid", "n_matches"):
            assert torch.equal(m[key], mb[key][b]), key
        g = guided_match(s.lm_pos, s.lm_desc, s.lm_valid, T_pred[b], step.K, f.xy, f.desc, f.valid, W, H,
                         radius_px=radius[b])
        for key in ("lm_idx", "valid", "pts3d", "n_matches"):
            assert torch.equal(g[key], gb[key][b]), key
        assert int(g["n_matches"]) > 0
        idx = _sample_minimal_sets(torch.Generator().manual_seed(10 + b), mb["valid"][b], 64, 6)
        assert torch.equal(idx, idx_b[b])
    pair_valid = mb["valid"] & take_rows(sb.ref_has_landmark, mb["train_idx"], 1)
    pts3d = take_rows(sb.ref_landmarks, mb["train_idx"], 1)
    xy_n = normalize_points(step.Kinv, fb.xy)
    T_b, inl_b = step.solve_pose(pts3d, xy_n, pair_valid, T_pred, gens, sample_idx=idx_b)
    for b in range(B):
        T, inl = step.solve_pose(pts3d[b], xy_n[b], pair_valid[b], T_pred[b], None, sample_idx=idx_b[b])
        np.testing.assert_allclose(T_b[b].numpy(), T.numpy(), atol=1e-4)
        assert int(inl.sum()) >= 20 and abs(int(inl.sum()) - int(inl_b[b].sum())) <= 2


@pytest.mark.parametrize("local_map", [False, True])
def test_batched_step_matches_single_steps(worlds, local_map):
    """``make_batched_vo`` over frames 1-2 against B single steps with the
    same generator seeds: every sequence within (R 0.01, t 0.06) of its
    single step and of ground truth, >= 20 inliers; ``split_track_outputs``
    gives each sequence's output."""
    bstep = make_batched_vo(K, device="cpu", local_map=local_map, **STEP_KW)
    step = tp.make_track_step(K, device="cpu", local_map=local_map, **STEP_KW)
    sb = tp.stack_track_states(make_states(worlds, "cpu", local_map))
    singles = make_states(worlds, "cpu", local_map)
    for i in (1, 2):
        imgs = torch.from_numpy(np.stack([w.frames[i] for w in worlds]))
        sb, ob = bstep(sb, imgs)
        assert ob.T_w2c.shape == (B, 4, 4) and ob.pnp_inliers.shape == (B, NF)
        for b, o_b in enumerate(tp.split_track_outputs(ob)):
            singles[b], o = step(singles[b], imgs[b])
            assert int(o_b.n_inliers) >= 20 and int(o.n_inliers) >= 20
            assert bool(o_b.guided_valid.any()) == local_map
            _assert_pose(o_b.T_w2c.numpy(), o.T_w2c.numpy())
            _assert_pose(o_b.T_w2c.numpy(), worlds[b].Ts[i])


@pytest.mark.parametrize("local_map", [False, True])
def test_batched_step_matches_jax_make_batched_vo(worlds, jax_mods, local_map):
    """The JAX package's ``make_batched_vo`` (vmap of its step, one device of
    the CPU mesh) and the port's, from the same stacked state carried over
    bit for bit: per sequence, frames 1-2 within (R 0.01, t 0.06) of each
    other and of ground truth. RANSAC draws differ (torch cannot reproduce
    JAX's random bits), so poses are compared, not draws."""
    jax, jp = jax_mods
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.parallel.multiseq import make_batched_vo as j_make_batched_vo

    states = []
    for b, w in enumerate(worlds):
        f0 = detect_and_describe(jnp.asarray(w.frames[0]), num_features=NF, threshold=12.0, n_levels=2, grid=4)
        lm, has, lm_pos, lm_valid = reference_block(w, np.asarray(f0.xy), np.asarray(f0.valid))
        s = jp.init_track_state(f0, lm, has, np.eye(4), seed=b, local_map_size=M if local_map else 0)
        if local_map:
            lm_desc = np.zeros((M, 8), np.uint32)
            lm_desc[:NF] = np.asarray(f0.desc)
            s = jp.set_local_map(s, lm_pos, lm_desc, lm_valid)
        states.append(s)
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    np_states = jax.tree.map(np.asarray, jstates)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    jstep = j_make_batched_vo(jnp.asarray(K), mesh, local_map=local_map, **STEP_KW)
    tstep = make_batched_vo(K, mesh=make_mesh("seq", devices=["cpu"]), local_map=local_map, **STEP_KW)
    ts = interop.batched_track_state_from_numpy(np_states, "cpu", seeds=range(B))
    for i in (1, 2):
        imgs = np.stack([w.frames[i] for w in worlds])
        jstates, jo = jstep(jstates, jnp.asarray(imgs))
        ts, to = tstep(ts, torch.from_numpy(imgs))
        T_j, T_t = np.asarray(jo.T_w2c), to.T_w2c.numpy()
        for b in range(B):
            assert int(to.n_inliers[b]) >= 20, (i, b, int(to.n_inliers[b]))
            _assert_pose(T_t[b], T_j[b])
            _assert_pose(T_t[b], worlds[b].Ts[i])
            _assert_pose(T_j[b], worlds[b].Ts[i])
        if local_map:
            assert (to.guided_valid.sum(-1) > 0).all()


def _pyramid_batch(rng, B_, sizes=((60, 80), (50, 67)), counts=(21, 0)):
    """B frames of 2 levels: one level without keypoints, centres on the
    corners, at -1 and at H / W."""
    raws, blurs, yxs = [], [], []
    for (h, w), k in zip(sizes, counts):
        yx = np.stack([rng.integers(0, h, (B_, k)), rng.integers(0, w, (B_, k))], -1).astype(np.int32)
        if k >= 4:
            yx[:, :4] = [[0, 0], [h - 1, w - 1], [-1, w], [h, -1]]
        raws.append(torch.from_numpy(rng.uniform(0, 255, (B_, h, w)).astype(np.float32)))
        blurs.append(torch.from_numpy(rng.uniform(0, 255, (B_, h, w)).astype(np.float32)))
        yxs.append(torch.from_numpy(yx))
    return raws, blurs, yxs


def test_batched_refs_equal_a_loop_of_single_refs():
    """The batched plain versions of K1, K2 and K3 equal today's plain
    versions called per sequence, exactly; one sequence has no valid
    query / keypoint. On CPU tensors the batched wrappers run them and
    launch nothing."""
    rng = np.random.default_rng(51)
    w = torch.from_numpy(torb.MOMENT_W_NP)
    raws, blurs, yxs = _pyramid_batch(rng, 4)
    mom, pat = patches_and_moments_batched_ref(raws, blurs, yxs, w)
    for b in range(4):
        m1, p1 = patches_and_moments_levels_ref([r[b] for r in raws], [x[b] for x in blurs], [y[b] for y in yxs], w)
        assert torch.equal(mom[b], m1) and torch.equal(pat[b], p1)

    d1 = torch.from_numpy(rng.integers(0, 2**32, (4, 90, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    d2 = torch.from_numpy(rng.integers(0, 2**32, (4, 70, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    d1[:, 10:40] = d2[:, 5:35]
    d2[:, 50:55] = d2[:, 5:10]  # row ties
    v1, v2 = torch.from_numpy(rng.random((4, 90)) > 0.1), torch.from_numpy(rng.random((4, 70)) > 0.1)
    v1[2] = False
    top = mk.hamming_top2_paired_ref(d1, d2, v1, v2)
    for b in range(4):
        assert all(torch.equal(a[b], r) for a, r in zip(top, mk.hamming_top2_ref(d1[b], d2[b], v1[b], v2[b])))
    assert (top[0][2] == mk.BIG).all()

    uv = torch.from_numpy(rng.uniform(0, 100, (4, 120, 2)).astype(np.float32))
    xy = torch.from_numpy(rng.uniform(0, 100, (4, 90, 2)).astype(np.float32))
    xy[:, 10:40] = uv[:, 5:35] + 1.5
    lm_desc = torch.from_numpy(rng.integers(0, 2**32, (4, 120, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
    lm_desc[:, 5:35] = d1[:, 10:40]
    lm_ok = torch.from_numpy(rng.random((4, 120)) > 0.1)
    r2 = torch.tensor([4.0, 9.0, 16.0, 1.0])
    g = mk.guided_top2_batched_ref(lm_desc, lm_ok, uv, d1, v1, xy, r2)
    for b in range(4):
        one = mk.guided_top2_ref(lm_desc[b], lm_ok[b], uv[b], d1[b], v1[b], xy[b], r2[b])
        assert torch.equal(g[0][b], one[0]) and torch.equal(g[1][b], one[1])
    assert int(g[1].sum()) > 20 and not bool(g[1][2].any())

    counters = (patches_and_moments_batched, mk.hamming_top2_paired, mk.guided_top2_batched)
    before = [c.launches for c in counters]
    got = (patches_and_moments_batched(raws, blurs, yxs, w), mk.hamming_top2_paired(d1, d2, v1, v2),
           mk.guided_top2_batched(lm_desc, lm_ok, uv, d1, v1, xy, r2))
    for out, ref in zip(got, ((mom, pat), top, g)):
        assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert [c.launches for c in counters] == before


def test_stack_split_and_interop_round_trip(worlds, jax_mods):
    """``stack_track_states`` stacks every leaf and keeps the generators;
    ``batched_track_state_from_numpy`` carries a stacked JAX ``TrackState``
    (numpy leaves) over bit for bit, with one generator per seed."""
    jax, jp = jax_mods
    from visual_slam_tpu.ops.detector import Features as JFeatures

    singles = make_states(worlds, "cpu", local_map=True)
    sb = tp.stack_track_states(singles)
    assert sb.lm_desc.shape == (B, M, 8) and sb.ref_feats.desc.shape == (B, NF, 8) and len(sb.gen) == B
    assert all(g is s.gen for g, s in zip(sb.gen, singles))
    for b, s in enumerate(singles):
        assert torch.equal(sb.ref_landmarks[b], s.ref_landmarks) and torch.equal(sb.lm_desc[b], s.lm_desc)

    def as_jax_fields(s, b):
        f = s.ref_feats
        return jp.TrackState(
            ref_feats=JFeatures(*[interop.desc_to_uint32(x) if name == "desc" else x.numpy()
                                  for name, x in zip(f._fields, f)]),
            ref_landmarks=s.ref_landmarks.numpy(), ref_has_landmark=s.ref_has_landmark.numpy(),
            T_w2c=s.T_w2c.numpy(), T_rel=s.T_rel.numpy(), key=np.asarray(jax.random.PRNGKey(b)),
            lm_pos=s.lm_pos.numpy(), lm_desc=interop.desc_to_uint32(s.lm_desc), lm_valid=s.lm_valid.numpy())

    np_states = jax.tree.map(lambda *xs: np.stack(xs), *[as_jax_fields(s, b) for b, s in enumerate(singles)])
    ts = interop.batched_track_state_from_numpy(np_states, "cpu", seeds=(7, 8, 9))
    for name in ("ref_landmarks", "ref_has_landmark", "T_w2c", "T_rel", "lm_pos", "lm_valid"):
        assert torch.equal(getattr(ts, name), getattr(sb, name)), name
    assert all(torch.equal(a, b) for a, b in zip(ts.ref_feats, sb.ref_feats)) and torch.equal(ts.lm_desc, sb.lm_desc)
    assert [torch.rand(1, generator=g).item() for g in ts.gen] == [
        torch.rand(1, generator=torch.Generator().manual_seed(s)).item() for s in (7, 8, 9)]
    with pytest.raises(ValueError):
        interop.batched_track_state_from_numpy(np_states, "cpu", seeds=(1,))
    step = tp.make_track_step(K, device="cpu", local_map=True, **STEP_KW)
    _, out = step(sb, torch.from_numpy(np.stack([w.frames[1] for w in worlds])))
    split = tp.split_track_outputs(out)
    assert len(split) == B and all(torch.equal(o.features.desc, out.features.desc[b]) for b, o in enumerate(split))


def test_batched_vo_family_and_mesh(worlds):
    """``BatchedVO`` and ``shard_batch`` over a one-device mesh give the
    batched step's result; a mesh of two devices raises, naming M14; a
    step fed frames and generators of different counts raises."""
    mesh = make_mesh("seq", devices=["cpu"])
    vo = BatchedVO(K, mesh=mesh, **STEP_KW)
    sb = shard_batch(mesh, "seq", tp.stack_track_states(make_states(worlds, "cpu", local_map=False)))
    imgs = np.stack([w.frames[1] for w in worlds])
    _, out = vo.track(sb, imgs)
    ref_state = tp.stack_track_states(make_states(worlds, "cpu", local_map=False))
    _, ref = make_batched_vo(K, device="cpu", **STEP_KW)(ref_state, torch.from_numpy(imgs))
    assert torch.equal(out.T_w2c, ref.T_w2c)
    two = make_mesh("seq", devices=["cpu", "cpu"])
    assert two.shape == {"seq": 2}
    with pytest.raises(NotImplementedError, match="M14"):
        make_batched_vo(K, mesh=two, **STEP_KW)
    with pytest.raises(NotImplementedError, match="M14"):
        BatchedVO(K, mesh=two, **STEP_KW)
    with pytest.raises(NotImplementedError, match="M14"):
        shard_batch(two, "seq", sb)
    with pytest.raises(ValueError):
        vo.step(sb, torch.from_numpy(imgs[:2]))


@pytest.mark.cuda
def test_batched_track_step_cuda_launches_once():
    """The batched step on the card: each of K1, K2 and K3 launches once per
    step for B = 3 sequences, the one-sequence wrappers not at all, and
    every sequence's pose stays within (R 0.01, t 0.06) of the same batched
    step run on the CPU through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    cuda = torch.device("cuda")
    worlds = make_worlds()
    steps = {d: make_batched_vo(K, device=d, local_map=True, **STEP_KW) for d in ("cpu", "cuda")}
    states = {d: tp.stack_track_states(make_states(worlds, d, local_map=True)) for d in ("cpu", "cuda")}
    counters = (patches_and_moments_batched, mk.hamming_top2_paired, mk.guided_top2_batched,
                patches_and_moments_levels, mk.hamming_top2, mk.guided_top2)
    before = [c.launches for c in counters]
    for i in (1, 2):
        imgs = torch.from_numpy(np.stack([w.frames[i] for w in worlds]))
        states["cpu"], o_cpu = steps["cpu"](states["cpu"], imgs)
        states["cuda"], o_gpu = steps["cuda"](states["cuda"], imgs.to(cuda))
        T_c, T_g = o_cpu.T_w2c.numpy(), o_gpu.T_w2c.cpu().numpy()
        assert (o_gpu.n_inliers.cpu().numpy() >= 20).all()
        for b in range(B):
            _assert_pose(T_g[b], T_c[b])
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 2, 0, 0, 0]
