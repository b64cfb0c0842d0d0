"""The port's inverted-file Hamming index (``ops.ann``) and ``FlannMatcher``
against the JAX package on the CPU, and tests/test_ann.py's properties on
the port. Distances are integers, so the index is held exactly: the same
anchors, buckets and ids (the same numpy draw), and the same search table
(ties to the lower index, as ``lax.top_k`` and ``argmin`` take them)."""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.ops.ann import build_ivf_index, ivf_search, popcount32
from visual_slam_tpu_torch.ops.detector import Features
from visual_slam_tpu_torch.ops.match_kernels import hamming_distances
from visual_slam_tpu_torch.ops.matching import match_descriptors

from test_ann import _perturb, _random_db

torch.set_num_threads(1)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def db():
    """test_ann.py's database: 2048 random rows from seed 0, the last 32
    invalid, and 256 perturbed queries of valid rows."""
    rng = np.random.default_rng(0)
    n = 2048
    desc = _random_db(rng, n)
    valid = np.ones(n, bool)
    valid[-32:] = False
    q_rows = rng.choice(np.nonzero(valid)[0], size=256, replace=False)
    qdesc = _perturb(rng, desc[q_rows])
    return desc, valid, q_rows, qdesc, build_ivf_index(_t(desc), _t(valid), n_clusters=64, seed=1)


def test_popcount_is_exact():
    rng = np.random.default_rng(2)
    a = _random_db(rng, 64)
    b = _random_db(rng, 64)
    b[:4] = a[:4]
    b[4] = ~a[4]
    x = _t(a)[:, None, :] ^ _t(b)[None, :, :]
    np.testing.assert_array_equal(popcount32(x).sum(-1).numpy(), hamming_distances(_t(a), _t(b)).numpy())
    edge = torch.tensor([0, -1, -(2**31), 2**31 - 1, 1, 0x55555555], dtype=torch.int32)
    np.testing.assert_array_equal(popcount32(edge).numpy(), [0, 32, 1, 31, 1, 16])


def test_index_matches_jax(db):
    from visual_slam_tpu.ops.ann import build_ivf_index as jbuild

    desc, valid, _, _, index = db
    ref = jbuild(desc, valid, n_clusters=64, seed=1)
    np.testing.assert_array_equal(index.anchors.numpy(), np.asarray(ref.anchors).view(np.int32))
    np.testing.assert_array_equal(index.bucket_desc.numpy(), np.asarray(ref.bucket_desc).view(np.int32))
    np.testing.assert_array_equal(index.bucket_ids.numpy(), np.asarray(ref.bucket_ids))
    np.testing.assert_array_equal(index.bucket_valid.numpy(), np.asarray(ref.bucket_valid))
    assert (index.n_clusters, index.bucket_cap) == (ref.n_clusters, ref.bucket_cap)


@pytest.mark.parametrize("n_probe,ratio,n_train", [(8, 0.9, None), (4, 0.75, 2048), (1, 0.0, None)])
def test_search_matches_jax(db, n_probe, ratio, n_train):
    from visual_slam_tpu.ops.ann import build_ivf_index as jbuild
    from visual_slam_tpu.ops.ann import ivf_search as jsearch

    desc, valid, _, qdesc, index = db
    qvalid = np.ones(len(qdesc), bool)
    qvalid[:3] = False
    ref = jsearch(jbuild(desc, valid, n_clusters=64, seed=1), qdesc, qvalid, n_probe=n_probe, ratio=ratio,
                  n_train=n_train)
    got = ivf_search(index, _t(qdesc), _t(qvalid), n_probe=n_probe, ratio=ratio, n_train=n_train)
    for k in ("train_idx", "distance", "valid", "n_matches"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_ivf_recall_vs_exact(db):
    desc, valid, q_rows, qdesc, index = db
    qvalid = torch.ones(len(q_rows), dtype=torch.bool)
    approx = ivf_search(index, _t(qdesc), qvalid, n_probe=8, ratio=0.9)
    ti, ok = approx["train_idx"].numpy(), approx["valid"].numpy()
    assert float((ok & (ti == q_rows)).mean()) >= 0.9
    exact = match_descriptors(_t(qdesc), _t(desc), qvalid, _t(valid), ratio=0.9, cross_check=False)
    ti_e, ok_e = exact["train_idx"].numpy(), exact["valid"].numpy()
    both = ok & ok_e
    assert float((ti[both] == ti_e[both]).mean()) >= 0.95
    same = both & (ti == ti_e)
    np.testing.assert_array_equal(approx["distance"].numpy()[same], exact["distance"].numpy()[same])


def test_ivf_never_matches_invalid_rows(db):
    desc, valid, _, _, index = db
    res = ivf_search(index, _t(desc[-16:]), torch.ones(16, dtype=torch.bool), n_probe=8, ratio=0.0)
    ok = res["valid"].numpy()
    assert valid[res["train_idx"].numpy()[ok]].all()


def test_ivf_invalid_queries_masked(db):
    desc, _, _, _, index = db
    assert not ivf_search(index, _t(desc[:8]), torch.zeros(8, dtype=torch.bool), n_probe=4)["valid"].any()


def test_flann_matcher_routes_to_ivf():
    """Exact below the threshold, IVF at or above it, the index cached on
    the train block's identity; the IVF result recalls the planted matches
    and equals the JAX matcher's."""
    import jax.numpy as jnp

    from visual_slam_tpu.frontend.matcher import FlannMatcher as JFlann
    from visual_slam_tpu.ops.detector import Features as JFeatures
    from visual_slam_tpu_torch.frontend.matcher import FlannMatcher

    rng = np.random.default_rng(3)
    desc = _random_db(rng, 512)
    q_rows = rng.choice(512, size=64, replace=False)
    qdesc = _perturb(rng, desc[q_rows])

    def feats(d):
        k = d.shape[0]
        return Features(xy=torch.zeros(k, 2), response=torch.ones(k), angle=torch.zeros(k),
                        octave=torch.zeros(k, dtype=torch.int32), size=torch.ones(k), desc=_t(d),
                        valid=torch.ones(k, dtype=torch.bool))

    def jfeats(d):
        k = d.shape[0]
        return JFeatures(xy=jnp.zeros((k, 2)), response=jnp.ones(k), angle=jnp.zeros(k),
                         octave=jnp.zeros(k, jnp.int32), size=jnp.ones(k), desc=jnp.asarray(d),
                         valid=jnp.ones(k, bool))

    kw = dict(ann_threshold=256, n_probe=8, n_clusters=16, ratio=0.9)
    m = FlannMatcher(**kw)
    f_train = feats(desc)
    res = m.match(feats(qdesc), f_train)
    assert m._index is not None
    ti, ok = res["train_idx"].numpy(), res["valid"].numpy()
    assert float((ok & (ti == q_rows)).mean()) >= 0.85
    ref = JFlann(**kw).match(jfeats(qdesc), jfeats(desc))
    np.testing.assert_array_equal(ti, np.asarray(ref["train_idx"]))
    np.testing.assert_array_equal(ok, np.asarray(ref["valid"]))
    idx_obj = m._index
    m.match(feats(qdesc), f_train)
    assert m._index is idx_obj
    # Below the threshold, and for float blocks, the exact matcher.
    small = FlannMatcher(ann_threshold=1024).match(feats(qdesc), f_train)
    exact = match_descriptors(_t(qdesc), _t(desc), torch.ones(64, dtype=torch.bool), torch.ones(512, dtype=torch.bool))
    np.testing.assert_array_equal(small["valid"].numpy(), exact["valid"].numpy())
