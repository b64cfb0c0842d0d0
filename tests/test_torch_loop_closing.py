"""Loop closing of the torch port against the JAX package on the CPU:
signatures, pose-graph builders and solvers, and LoopClosing's detect,
_verify, close and process_keyframe on the same map in both packages.

The map is a drifted keyframe map of a rendered ring world at 320x240
(tests/loop_world.py): 16 keyframes around one loop, the last revisiting
the first. Tolerances: signatures exact (integer projections, exact f32
norms), scores 1e-6; match counts, shortlists, covisibility edges and
inliers exact; poses, scales and landmarks 1e-4 (f32 Gauss-Newton and LU
in different operation orders) except after close, where 15 Sim(3)
iterations on a 16-node graph compound them (2e-3, about 1e-4 of the
scene's 10 m scale).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loop_world as lw
from visual_slam_tpu import map as jmap
from visual_slam_tpu.camera import PinholeCamera as JCamera
from visual_slam_tpu.config import Config as JConfig
from visual_slam_tpu.loop_closing import loop_closing as jlcm
from visual_slam_tpu.loop_closing import pose_graph as jpg
from visual_slam_tpu.loop_closing import signature as jsig
from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu.ops import matching as jmatch
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu_torch import interop, pipeline
from visual_slam_tpu_torch import map as tmap
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.loop_closing import LoopClosing
from visual_slam_tpu_torch.loop_closing import pose_graph as tpg
from visual_slam_tpu_torch.loop_closing import signature as tsig
from visual_slam_tpu_torch.ops.matching import match_descriptors

torch.set_num_threads(1)

ATOL = 1e-4
CLOSE_ATOL = 2e-3
W, H, F = 320, 240, 260.0


@pytest.fixture(scope="module")
def ring():
    """16 keyframes (every 4th of 64 frames) of the ring world, the port's
    features of each (512, 2 levels), the matches linking each to the
    previous one, the drifted poses and the landmarks."""
    K, T_gt, imgs, depths = lw.ring_keyframes(n_frames=64, every=4, width=W, height=H, f=F, n_sprites=420)
    step = pipeline.make_track_step(K, device="cpu", num_features=512, n_levels=2, grid=4, fast_threshold=12.0)
    feats = [step.detect(torch.from_numpy(im)) for im in imgs]
    links = [None]
    for a, b in zip(feats[1:], feats[:-1]):
        r = match_descriptors(a.desc, b.desc, a.valid, b.valid, a.angle, b.angle, use_orientation=True)
        links.append((r["train_idx"].numpy(), r["valid"].numpy()))
    T_d, s = lw.drift(T_gt)
    jfeats = [JFeatures(*[np.asarray(x) for x in f._replace(desc=interop.desc_to_uint32(f.desc))]) for f in feats]
    lms = [lw.landmarks(f.xy.numpy(), f.valid.numpy(), depths[k], K, T_d[k], s[k]) for k, f in enumerate(feats)]
    return SimpleNamespace(K=K, T_gt=T_gt, jfeats=jfeats, links=links, T_d=T_d, lms=lms)


def _add(pkg, m, kf, ring, k, prev):
    X, has = ring.lms[k]
    lw.add_keyframe(pkg, m, kf, X, has, prev, ring.links[k])


def _jax_kf(ring, k):
    return jmap.KeyFrame(features=[ring.jfeats[k]], timestamp=float(k), pose=jmap.Pose(ring.T_d[k]))


def _maps(ring):
    """The JAX map of all 16 keyframes, and the port's copy of it."""
    jm = jmap.Map()
    prev = None
    for k in range(len(ring.jfeats)):
        kf = _jax_kf(ring, k)
        _add(jmap, jm, kf, ring, k, prev)
        prev = kf
    return jm, interop.map_from_numpy(jm.get_keyframes(), jm.get_map_points())


def _closers(ring, jm, tm):
    return (jlcm.LoopClosing(jm, JCamera(W, H, ring.K), JConfig()),
            LoopClosing(tm, PinholeCamera(W, H, ring.K), Config()))


# --- signatures --------------------------------------------------------------


def test_signatures_match_jax(ring):
    """keyframe_signature and batch_signatures equal JAX's bit for bit on
    the ring's keyframes, random blocks and an all-invalid block;
    score_signatures within 1e-6."""
    np.testing.assert_array_equal(tsig._make_codebook(), jsig._make_codebook())
    rng = np.random.default_rng(40)
    descs = np.stack([f.desc for f in ring.jfeats] + [rng.integers(0, 2**32, (512, 8), dtype=np.uint64).astype(np.uint32)
                                                      for _ in range(3)])
    valids = np.stack([f.valid for f in ring.jfeats] + [rng.random(512) > 0.3 for _ in range(2)] + [np.zeros(512, bool)])
    got = tsig.batch_signatures(torch.from_numpy(descs.view(np.int32)), torch.from_numpy(valids))
    np.testing.assert_array_equal(got, jsig.batch_signatures(descs, valids))
    one = tsig.keyframe_signature(torch.from_numpy(descs[3].view(np.int32)), torch.from_numpy(valids[3])).numpy()
    np.testing.assert_array_equal(one, np.asarray(jsig.keyframe_signature(descs[3], valids[3])))
    np.testing.assert_allclose(tsig.score_signatures(got[0], got), jsig.score_signatures(got[0], got), atol=1e-6)


# --- pose graphs -------------------------------------------------------------


def _fields_equal(jg, tg):
    for name in jg._fields:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name)


def test_graph_builders_match_jax(ring):
    poses = ring.T_d
    T_meas = ring.T_gt[-1] @ np.linalg.inv(ring.T_gt[0])
    covis = [(2, 5, 0.5), (3, 7, 0.25)]
    _fields_equal(jpg.build_sim3_graph(poses, [(15, 0, T_meas, 1.3)], covis),
                  tpg.build_sim3_graph(poses, [(15, 0, T_meas, 1.3)], covis))
    loops = [(15, 0, T_meas), (12, 1, T_meas, 0.7)]
    _fields_equal(jpg.build_sequential_graph(poses, loops), tpg.build_sequential_graph(poses, loops))
    _fields_equal(jpg.build_sequential_graph(poses, loops, n_slots=20, e_slots=24),
                  tpg.build_sequential_graph(poses, loops, n_slots=20, e_slots=24))


def _problem(name):
    if name == "drifted_loop12":
        poses, loops, _ = lw.sim3_loop_problem(12, n_loops=2)
        return poses, loops
    poses, loops = lw.bench_pose_graph_problem(32, 3)
    return poses, [(i, j, T, 1.0) for i, j, T in loops]


@pytest.mark.parametrize("name", ["drifted_loop12", "bench32"])
def test_optimize_graphs_match_jax(name):
    """optimize_sim3_graph and optimize_pose_graph on a 12-node drifted loop
    and on bench_pose_graph's generator at 32 nodes: poses and scales within
    1e-4 of JAX's, and the cost falls."""
    poses, loops = _problem(name)
    T_j, s_j, info_j = jpg.optimize_sim3_graph(jpg.build_sim3_graph(poses, loops), n_iter=10)
    T_t, s_t, info_t = tpg.optimize_sim3_graph(tpg.build_sim3_graph(poses, loops), n_iter=10)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    np.testing.assert_allclose(info_t["costs"].numpy(), np.asarray(info_j["costs"]), rtol=1e-3, atol=1e-6)
    assert float(info_t["cost"]) < 0.1 * float(info_t["costs"][0])

    se3 = [(i, j, T) for i, j, T, _ in loops]
    T_j, info_j = jpg.optimize_pose_graph(jpg.build_sequential_graph(poses, se3), n_iter=10)
    T_t, info_t = tpg.optimize_pose_graph(tpg.build_sequential_graph(poses, se3), n_iter=10)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=ATOL)
    assert float(info_t["cost"]) < float(info_t["costs"][0])


def test_sim3_on_bench256_diverges_like_jax():
    """bench_pose_graph's own problem at 256 nodes (a 128 m chain along x,
    8 loops, seed 3) defeats the reference's f32 Sim(3) Gauss-Newton: JAX's
    cost jumps more than tenfold on the first iteration and has not fallen
    after 10 (it ends in NaN), and the port's does the same from the same
    starting cost (1e-6 relative). This is why chip_smoke.py times
    optimize_sim3_graph at 256 nodes on a drifted loop instead
    (loop_world.sim3_loop_problem), where both converge."""
    poses, loops = lw.bench_pose_graph_problem(256, 8)
    loops = [(i, j, T, 1.0) for i, j, T in loops]
    c_j = np.asarray(jpg.optimize_sim3_graph(jpg.build_sim3_graph(poses, loops), n_iter=10)[-1]["costs"])
    c_t = tpg.optimize_sim3_graph(tpg.build_sim3_graph(poses, loops), n_iter=10)[-1]["costs"].numpy()
    np.testing.assert_allclose(c_t[0], c_j[0], rtol=1e-6)
    for costs in (c_j, c_t):
        assert costs[1] > 10 * costs[0] and not costs[-1] < costs[0], costs


# --- LoopClosing on the same map ---------------------------------------------


def _jax_funnel(jlc, jm, q):
    """JAX detect's shortlist and match counts, by the same steps."""
    cands = [k for k in jm.get_keyframes()[:-jlc.min_gap] if k.keyframe_id != q.keyframe_id]
    short = jlc._signature_shortlist(q, cands)
    pad = jlcm._bucket(len(short)) - len(short)
    fs = [k.get_features(0) for k in short]
    f_q = q.get_features(0)
    res = jmatch.match_descriptors_batched(
        f_q.desc, np.stack([f.desc for f in fs] + [fs[0].desc] * pad), f_q.valid,
        np.stack([f.valid for f in fs] + [np.zeros_like(fs[0].valid)] * pad),
        f_q.angle, np.stack([f.angle for f in fs] + [fs[0].angle] * pad),
    )
    return [k.keyframe_id for k in short], np.asarray(res["n_matches"])[: len(short)].tolist()


def test_detect_matches_jax(ring):
    """The revisit keyframe: the same shortlist, exactly the same match
    count per candidate (through K4's plain version) and the same verified
    candidate, which is the first keyframe."""
    jm, tm = _maps(ring)
    jlc, tlc = _closers(ring, jm, tm)
    jq, tq = jm.get_keyframes()[-1], tm.get_keyframes()[-1]
    jdet, tdet = jlc.detect(jq), tlc.detect(tq)
    short, counts = _jax_funnel(jlc, jm, jq)
    assert tlc.funnel["shortlist"] == short
    assert tlc.funnel["n_matches"] == counts
    assert jdet is not None and tdet is not None
    assert tdet["candidate"].keyframe_id == jdet["candidate"].keyframe_id == jm.get_keyframes()[0].keyframe_id
    assert tdet["n_matches"] == jdet["n_matches"] >= 40


def test_verify_with_jax_draws_matches_jax(ring):
    """_verify fed the minimal sets JAX draws from PRNGKey(99): the same
    inliers, T within 1e-4, the same measured scale within 1e-4."""
    jm, tm = _maps(ring)
    jlc, tlc = _closers(ring, jm, tm)
    jq, jc = jm.get_keyframes()[-1], jm.get_keyframes()[0]
    tq, tc = tm.get_keyframes()[-1], tm.get_keyframes()[0]
    fq, fc = jq.get_features(0), jc.get_features(0)
    m = jmatch.match_descriptors(fq.desc, fc.desc, fq.valid, fc.valid, fq.angle, fc.angle,
                                 ratio=0.75, cross_check=True, use_orientation=True)
    ti, ok_match = np.asarray(m["train_idx"]), np.asarray(m["valid"])
    jres = jlc._verify(jq, jc, ti, ok_match)
    _, sub = jax.random.split(jax.random.PRNGKey(99))
    ok = ok_match & jc.point_arrays(0)[1][ti]
    idx = np.asarray(jepi._sample_minimal_sets(sub, jnp.asarray(ok), 256, 6))
    tres = tlc._verify(tq, tc, torch.from_numpy(ti), torch.from_numpy(ok_match), sample_idx=torch.from_numpy(idx))
    assert jres is not None and tres is not None
    assert tres["n_inliers"] == jres["n_inliers"] >= 20
    np.testing.assert_allclose(tres["T_kf_corrected"], jres["T_kf_corrected"], atol=ATOL)
    np.testing.assert_allclose(tres["s_meas"], jres["s_meas"], atol=ATOL)
    np.testing.assert_allclose(tres["s_meas"], 1.3, atol=0.05)  # the injected drift at the revisit


@pytest.mark.parametrize("use_sim3", [True, False])
def test_close_matches_jax(ring, use_sim3):
    """close() fed JAX's detection: identical covisibility edges, poses and
    landmarks within 2e-3 of JAX's, and the Sim(3) closure lowers the
    scale-aligned keyframe ATE."""
    jm, tm = _maps(ring)
    jlc, tlc = _closers(ring, jm, tm)
    jq, tq = jm.get_keyframes()[-1], tm.get_keyframes()[-1]
    jdet = jlc.detect(jq)
    tdet = dict(jdet, candidate=tm.get_keyframe_by_id(jdet["candidate"].keyframe_id))
    covis = jlc._covisibility_edges(jm.get_keyframes())
    assert tlc._covisibility_edges(tm.get_keyframes()) == covis and len(covis) > 0
    jr, tr = jlc.close(jq, jdet, use_sim3=use_sim3), tlc.close(tq, tdet, use_sim3=use_sim3)
    assert (tr["loop"], tr["covis_edges"], tr["landmarks_corrected"]) == (jr["loop"], jr["covis_edges"], jr["landmarks_corrected"])
    np.testing.assert_allclose(tr["pose_graph_cost"], jr["pose_graph_cost"], rtol=1e-2, atol=1e-6)
    T_t = np.stack([k.T_w2c for k in tm.get_keyframes()])
    np.testing.assert_allclose(T_t, np.stack([k.T_w2c for k in jm.get_keyframes()]), atol=CLOSE_ATOL)
    np.testing.assert_allclose(np.stack([p.position for p in tm.get_map_points()]),
                               np.stack([p.position for p in jm.get_map_points()]), atol=CLOSE_ATOL)
    if use_sim3:
        assert lw.keyframe_ate(T_t, ring.T_gt) < 0.5 * lw.keyframe_ate(ring.T_d, ring.T_gt)


def test_process_keyframe_closes_the_loop_like_jax(ring):
    """Keyframes added one at a time, process_keyframe on each, in both
    packages: the same keyframes return a closure (one, the last revisiting
    the first) and the port's closure lowers the keyframe ATE."""
    jm, tm = jmap.Map(), tmap.Map()
    jlc, tlc = _closers(ring, jm, tm)
    jprev = tprev = None
    for k in range(len(ring.jfeats)):
        jkf = _jax_kf(ring, k)
        tkf = interop.keyframe_from_numpy([ring.jfeats[k]], ring.T_d[k], jkf.keyframe_id, frame_id=jkf.id,
                                          timestamp=float(k))
        _add(jmap, jm, jkf, ring, k, jprev)
        _add(tmap, tm, tkf, ring, k, tprev)
        jres, tres = jlc.process_keyframe(jkf), tlc.process_keyframe(tkf)
        assert (jres is None) == (tres is None), k
        jprev, tprev = jkf, tkf
    assert tlc.closed_loops == jlc.closed_loops
    assert tlc.closed_loops == [(tm.get_keyframes()[-1].keyframe_id, tm.get_keyframes()[0].keyframe_id)]
    T_t = np.stack([k.T_w2c for k in tm.get_keyframes()])
    assert lw.keyframe_ate(T_t, ring.T_gt) < 0.5 * lw.keyframe_ate(ring.T_d, ring.T_gt)
