"""In-chunk keyframe promotion of the torch port against the JAX package on
the CPU: the self-promoting chunk (``make_track_chunk_promote``, whose
``promote_block`` the port keeps at module level), the compact boundary
fetch (``make_compact_chunk``, both ``with_sig`` arms) and the similarity
re-anchoring (``correction_similarity``, ``apply_correction``).

Both packages get identical step outputs: the tracking step is replaced by
a stub that returns a prepared ``TrackOutput`` per frame, so the chunk's
own logic (keyframe gates, the promotion, triangulation against the old
reference, padded flush frames) is what is compared. Tolerances: gate
decisions, ``ref_has``, ``ref_tri`` and slot order exact; positions within
1e-4 relative (float32 DLT in both); signatures within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu import pipeline as jpl
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu_torch import pipeline as tpl
from visual_slam_tpu_torch.interop import (
    features_from_numpy,
    promote_record_from_numpy,
    track_output_from_numpy,
    track_state_from_numpy,
)
from visual_slam_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

F, W, H = 300.0, 320, 240
KMAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
NK, NA, C = 64, 32, 6  # keypoint slots, arena rows, chunk frames
GATES = dict(min_inliers=10, keyframe_interval=2, kf_min_matches=40, kf_min_rotation_deg=10.0,
             kf_min_translation=1.0, min_depth=0.1, max_depth=100.0, min_parallax_deg=0.5,
             pnp_threshold_px=3.0)


def _pose(cx, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.array([cx, 0.0, 0.0])
    return T.astype(np.float32)


def _feats(rng, xy):
    return JFeatures(
        xy=jnp.asarray(xy, jnp.float32), response=jnp.ones(NK), angle=jnp.zeros(NK),
        octave=jnp.zeros(NK, jnp.int32), size=jnp.full(NK, 31.0),
        desc=jnp.asarray(rng.integers(0, 2**32, (NK, 8), dtype=np.uint64).astype(np.uint32)),
        valid=jnp.asarray(np.arange(NK) < NK - 4),
    )


@pytest.fixture(scope="module")
def scene():
    """Keypoint slot i of every frame sees world point i; the camera slides
    0.3 m per frame. A third of the reference slots carry landmarks, some
    keypoints match through the arena, a few matches are gross outliers and
    the inlier counts walk through every gate: a healthy frame under the
    interval, a promotion on the interval, one below ``kf_min_matches``, one
    below ``min_inliers`` (it must not promote)."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-3, 3, NK), rng.uniform(-2, 2, NK), rng.uniform(4, 12, NK)], 1)

    def project(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return (pc[:, :2] / pc[:, 2:3]) * F + KMAT[:2, 2] + rng.normal(0, 0.2, (NK, 2))

    T_ref = _pose(0.0)
    ref_feats = _feats(rng, project(T_ref))
    has = np.arange(NK) % 3 == 0
    ref_lm = np.where(has[:, None], X + rng.normal(0, 0.01, X.shape), 0.0).astype(np.float32)
    lm_pos = np.zeros((NA, 3), np.float32)
    lm_pos[:20] = X[1:41:2] + rng.normal(0, 0.01, (20, 3))  # arena rows carry odd points
    state = jpl.TrackState(
        ref_feats=ref_feats, ref_landmarks=jnp.asarray(ref_lm), ref_has_landmark=jnp.asarray(has),
        T_w2c=jnp.asarray(T_ref), T_rel=jnp.eye(4, dtype=jnp.float32), key=jax.random.PRNGKey(0),
        lm_pos=jnp.asarray(lm_pos), lm_desc=jnp.zeros((NA, 8), jnp.uint32), lm_valid=jnp.asarray(np.arange(NA) < 20),
    )
    n_inl = [60, 55, 30, 8, 50, 45]  # frame 3 is too weak to promote
    outs = []
    for c in range(C):
        T = _pose(0.3 * (c + 1), yaw=0.01 * c)
        xy = project(T)
        out_rows = rng.choice(NK, 3, replace=False)
        xy[out_rows] += 25.0  # gross outliers: triangulation must gate them
        m_ok = rng.random(NK) > 0.15
        inl = m_ok & (rng.random(NK) > 0.1)
        g_ok = np.zeros(NK, bool)
        g_idx = np.zeros(NK, np.int32)
        odd = np.arange(1, 41, 2)
        g_ok[odd] = rng.random(20) > 0.3
        g_idx[odd] = np.arange(20)
        outs.append(jpl.TrackOutput(
            T_w2c=jnp.asarray(T), n_inliers=jnp.int32(n_inl[c]), n_matches=jnp.int32(int(m_ok.sum())),
            features=_feats(rng, xy), match_train_idx=jnp.arange(NK, dtype=jnp.int32),
            match_valid=jnp.asarray(m_ok), pnp_inliers=jnp.asarray(inl),
            guided_idx=jnp.asarray(g_idx), guided_valid=jnp.asarray(g_ok),
        ))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *outs)
    return state, stacked, T_ref


class _JaxStub:
    """A JAX tracking step that returns frame ``img``'s prepared output."""

    def __init__(self, outs):
        self.jitted = lambda s, img, sampling: (s, jax.tree.map(lambda a: a[img], outs))


class _TorchStub:
    def __init__(self, outs):
        self.outs = outs
        self.K = torch.from_numpy(KMAT)

    def __call__(self, state, img):
        return state, tree_map(lambda a: a[int(img)], self.outs)


def _run_both(scene, n_valid, fsr0=0):
    state, outs, T_ref = scene
    jchunk = jpl.make_track_chunk_promote(_JaxStub(outs), jnp.asarray(KMAT), **GATES)
    js, jfsr, jT, jouts, jrecs = jchunk(state, fsr0, T_ref, jnp.arange(C, dtype=jnp.int32), n_valid=n_valid)
    touts = track_output_from_numpy(outs)
    tchunk = tpl.make_track_chunk_promote(_TorchStub(touts), KMAT, **GATES)
    ts, tfsr, tT, _, trecs = tchunk(track_state_from_numpy(state), fsr0, T_ref, torch.arange(C), n_valid=n_valid)
    return (js, jfsr, jT, jrecs), (ts, tfsr, tT, trecs)


def _check_recs(jrecs, trecs):
    np.testing.assert_array_equal(trecs.promoted.numpy(), np.asarray(jrecs.promoted))
    np.testing.assert_array_equal(trecs.ref_has.numpy(), np.asarray(jrecs.ref_has))
    np.testing.assert_array_equal(trecs.ref_tri.numpy(), np.asarray(jrecs.ref_tri))
    pj = np.asarray(jrecs.ref_pos)
    np.testing.assert_allclose(trecs.ref_pos.numpy(), pj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_valid", [C, 4])
def test_chunk_promote_matches_jax(scene, n_valid):
    (js, jfsr, jT, jrecs), (ts, tfsr, tT, trecs) = _run_both(scene, n_valid)
    promoted = np.asarray(jrecs.promoted)
    # The interval gate fires on frames 2 and 5; frame 3 trips the match
    # gate but is too weak to promote; padded frames never promote.
    assert promoted.tolist() == [False, False, True, False, False, True][:n_valid] + [False] * (C - n_valid)
    assert np.asarray(jrecs.ref_tri).any() and not np.asarray(jrecs.ref_tri).all()
    _check_recs(jrecs, trecs)
    assert int(tfsr) == int(jfsr)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-6)
    np.testing.assert_array_equal(ts.ref_has_landmark.numpy(), np.asarray(js.ref_has_landmark))
    np.testing.assert_allclose(ts.ref_landmarks.numpy(), np.asarray(js.ref_landmarks), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ts.ref_feats.xy.numpy(), np.asarray(js.ref_feats.xy))


def test_promote_block_matches_jax(scene):
    """The module-level ``promote_block`` on frame 0 equals the JAX chunk's
    record for a one-frame chunk that promotes at once (fsr past the
    interval)."""
    state, outs, T_ref = scene
    one = jax.tree.map(lambda a: a[:1], outs)
    jchunk = jpl.make_track_chunk_promote(_JaxStub(one), jnp.asarray(KMAT), **GATES)
    js, _, _, _, jrecs = jchunk(state, 5, T_ref, jnp.zeros(1, jnp.int32))
    assert bool(jrecs.promoted[0])
    out0 = tree_map(lambda a: a[0], track_output_from_numpy(outs))
    g = GATES
    s2, pos, has, tri = tpl.promote_block(
        track_state_from_numpy(state), out0, torch.from_numpy(T_ref), torch.linalg.inv(torch.from_numpy(KMAT)),
        torch.tensor(g["min_depth"]), torch.tensor(g["max_depth"]), torch.tensor(np.deg2rad(g["min_parallax_deg"])),
        torch.tensor(g["pnp_threshold_px"] / F))
    np.testing.assert_array_equal(has.numpy(), np.asarray(jrecs.ref_has[0]))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jrecs.ref_tri[0]))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jrecs.ref_pos[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(s2.ref_has_landmark.numpy(), np.asarray(js.ref_has_landmark))


@pytest.mark.parametrize("P,with_sig", [(4, False), (1, True)])
def test_compact_chunk_matches_jax(scene, P, with_sig):
    """Identical outputs and records: every field exact but the signatures
    (1e-5); ``P = 1`` holds fewer slots than the chunk's two promotions, so
    the slot order and ``n_promoted`` overflow count are checked too."""
    state, outs, T_ref = scene
    (_, _, _, jrecs), _ = _run_both(scene, C)
    jc = jpl.make_compact_chunk(P, with_sig=with_sig)(outs, jrecs)
    tc = tpl.make_compact_chunk(P, with_sig=with_sig)(track_output_from_numpy(outs), promote_record_from_numpy(jrecs))
    assert int(tc.n_promoted) == int(jc.n_promoted) == 2
    np.testing.assert_array_equal(tc.slot_frame.numpy(), np.asarray(jc.slot_frame))
    for name in ("T_w2c", "n_inliers", "n_matches", "promoted", "match_train_idx", "match_valid", "pnp_inliers",
                 "guided_idx", "guided_valid", "ref_pos", "ref_has", "ref_tri"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), err_msg=name)
    fj = features_from_numpy(jc.feats)
    for a, b in zip(tc.feats, fj):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(tc.sig.numpy(), np.asarray(jc.sig), atol=1e-5)


def test_correction_similarity_and_apply_correction_match_jax(scene):
    state, _, T_ref = scene
    rng = np.random.default_rng(5)
    T_old = _pose(0.7, yaw=0.05).astype(np.float64)
    T_new = _pose(0.9, yaw=0.02).astype(np.float64)
    T_new[:3, 3] += rng.normal(0, 0.05, 3)
    s = 1.07
    Rj, tj = jpl.correction_similarity(T_old, T_new, s)
    Rt, tt = tpl.correction_similarity(T_old, T_new, s)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    state = state._replace(T_rel=jnp.asarray(_pose(0.3, yaw=0.01)), T_w2c=jnp.asarray(_pose(1.5, yaw=0.03)))
    js, jT = jpl.apply_correction(state, jnp.asarray(T_ref), jnp.asarray(Rj), jnp.asarray(tj), s)
    ts, tT = tpl.apply_correction(track_state_from_numpy(state), torch.from_numpy(T_ref), Rt, tt, s)
    for a, b in ((ts.T_w2c, js.T_w2c), (ts.T_rel, js.T_rel), (ts.ref_landmarks, js.ref_landmarks),
                 (ts.lm_pos, js.lm_pos), (tT, jT)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
