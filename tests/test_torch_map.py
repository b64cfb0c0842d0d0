"""The torch port's map/ against the JAX package's: the behaviour loop
closing relies on (landmark links and observations, point_arrays, pose
updates, host views of the feature block, removal and fusion), driven by
the same calls on both packages, and interop.map_from_numpy carrying a JAX
map across."""
import numpy as np
import pytest
import torch

from visual_slam_tpu import map as jmap
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import map as tmap

torch.set_num_threads(1)


def _features(rng, K=40):
    return dict(
        xy=rng.uniform(0, 300, (K, 2)).astype(np.float32),
        response=rng.uniform(0, 1, K).astype(np.float32),
        angle=rng.uniform(-3, 3, K).astype(np.float32),
        octave=rng.integers(0, 4, K).astype(np.int32),
        size=np.full(K, 31.0, np.float32),
        desc=rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32),
        valid=rng.random(K) > 0.2,
    )


def _build(pkg, feats_np, poses, to_features):
    """Three keyframes, landmarks on some slots, one landmark shared by all
    three, one removed and one fused: the same calls on either package."""
    m = pkg.Map()
    kfs = [pkg.KeyFrame(features=[to_features(f)], timestamp=float(k), pose=pkg.Pose(T))
           for k, (f, T) in enumerate(zip(feats_np, poses))]
    for kf in kfs:
        m.add_keyframe(kf)
    pts = []
    for n in range(12):
        mp = pkg.MapPoint(np.array([n, -n, 10.0 + n]))
        m.add_map_point(mp)
        pts.append(mp)
        kfs[n % 3].add_map_point(0, n, mp)
    for kf in kfs:
        kf.add_map_point(0, 20, pts[0])  # one landmark, three observers
    kfs[1].add_map_point(0, 22, pts[0])  # re-slotted: the old slot's link goes
    m.remove_map_point(pts[5])
    m.fuse_map_points(pts[3], pts[6])
    pts[4].update_position(np.array([1.0, 2.0, 3.0]))
    kfs[2].update_pose(np.asarray(poses[0]))
    return m, kfs, pts


def _state(m, kfs):
    out = {"points": [(mp.id - m.get_map_points()[0].id, tuple(mp.position), sorted(mp.observations.items()))
                      for mp in m.get_map_points()]}
    base = kfs[0].keyframe_id
    for r, kf in enumerate(kfs):
        pos, has = kf.point_arrays(0)
        out[r] = dict(pos=pos, has=has, T=kf.T_w2c, desc=kf.descriptors(0).view(np.uint32), valid=kf.valid_mask(0),
                      xy=kf.keypoints(0), n=kf.num_map_points(), nf=kf.num_features(0),
                      links=sorted((k, mp.id - m.get_map_points()[0].id) for k, mp in kf.map_points.items()),
                      id=kf.keyframe_id - base)
    out["points"] = [(i, p, [(k - base, c, s) for k, c, s in obs]) for i, p, obs in out["points"]]
    return out


def _assert_same(a, b):
    assert a["points"] == b["points"]
    for r in range(3):
        assert a[r].pop("links") == b[r].pop("links")
        for key in a[r]:
            np.testing.assert_array_equal(np.asarray(a[r][key]), np.asarray(b[r][key]), err_msg=f"kf {r} {key}")


@pytest.mark.parametrize("device", ["cpu", "tensor"])
def test_map_behaviour_matches_jax(device):
    """The same sequence of map operations on both packages leaves the same
    landmarks, observations, links, dense point arrays and poses; the
    port's keyframes may hold tensors and give the same numpy views
    (descriptors as int32 words, bit for bit the JAX uint32)."""
    rng = np.random.default_rng(30)
    feats_np = [_features(rng) for _ in range(3)]
    poses = [np.eye(4) for _ in range(3)]
    for k, T in enumerate(poses):
        T[:3, 3] = [k, 0.5 * k, -k]
    jm, jk, _ = _build(jmap, feats_np, poses, lambda f: JFeatures(**f))
    to_t = (lambda f: interop.features_from_numpy(JFeatures(**f))) if device == "tensor" else (
        lambda f: JFeatures(**{**f, "desc": f["desc"].view(np.int32)}))
    tm, tk, _ = _build(tmap, feats_np, poses, to_t)
    _assert_same(_state(jm, jk), _state(tm, tk))
    assert tk[0].descriptors(0).dtype == np.int32


def test_map_from_numpy_carries_a_jax_map():
    rng = np.random.default_rng(31)
    feats_np = [_features(rng) for _ in range(3)]
    poses = [np.eye(4) * 1.0 for _ in range(3)]
    jm, jk, _ = _build(jmap, feats_np, poses, lambda f: JFeatures(**f))
    tm = interop.map_from_numpy(jm.get_keyframes(), jm.get_map_points())
    tk = tm.get_keyframes()
    assert [k.keyframe_id for k in tk] == [k.keyframe_id for k in jk]
    assert [p.id for p in tm.get_map_points()] == [p.id for p in jm.get_map_points()]
    assert isinstance(tk[0].get_features(0).desc, torch.Tensor)
    _assert_same(_state(jm, jk), _state(tm, tk))
    assert tk[1].get_map_point(0, 20) is None and tk[1].get_map_point(0, 22).id == jk[1].get_map_point(0, 22).id


def _next_ids(pkg):
    kf = pkg.KeyFrame()
    return kf.id, kf.keyframe_id


def test_keyframe_ids_match_jax():
    """from_frame keeps the source frame's id, shares its features and
    takes one frame id and one keyframe id from the counters, as JAX's
    does; a copy through map_from_numpy keeps the JAX frame and keyframe
    ids and takes none from the port's counters."""
    rng = np.random.default_rng(32)
    f = _features(rng)
    steps = []
    for pkg, feats in ((jmap, JFeatures(**f)), (tmap, interop.features_from_numpy(JFeatures(**f)))):
        fr = pkg.Frame(features=[feats])
        kf = pkg.KeyFrame.from_frame(fr)
        assert kf.id == fr.id and kf.get_features(0) is feats
        after = _next_ids(pkg)
        steps.append((after[0] - fr.id, after[1] - kf.keyframe_id))
    assert steps[0] == steps[1]

    jm, jk, _ = _build(jmap, [_features(rng) for _ in range(3)], [np.eye(4)] * 3, lambda f: JFeatures(**f))
    before = _next_ids(tmap)
    tk = interop.map_from_numpy(jm.get_keyframes(), jm.get_map_points()).get_keyframes()
    assert _next_ids(tmap) == (before[0] + 1, before[1] + 1)
    assert [(k.id, k.keyframe_id) for k in tk] == [(k.id, k.keyframe_id) for k in jk]
