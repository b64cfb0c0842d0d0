"""Checkpoint files of the port (``visual_slam_tpu_torch.utils.serialization``)
against the JAX package's (``visual_slam_tpu.utils.serialization``), on a
small map made from a seed with numpy: three keyframes of 64 feature slots
with random poses, 40 landmarks (one marked bad, every fifth without a
descriptor) and observation links, some landmarks seen by two keyframes.
The JAX map is built with the JAX classes and carried into the port with
``interop.map_from_numpy``, so both packages hold the same map.

Everything is exact: the files' key sets and dtypes, every array in them
(descriptors bit for bit), the maps loaded back (ids, poses, features,
landmark positions and descriptors, observation links), the TUM and KITTI
text, and a tracking state's leaves. ``load_trajectory_tum`` agrees with
JAX's to 1e-12 on the same text.
"""
import itertools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu import map as jmap
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu.utils import serialization as jser
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import map as tmap
from visual_slam_tpu_torch import pipeline as tpipeline
from visual_slam_tpu_torch.utils import serialization as tser

N_KF, N_SLOTS, N_MP = 3, 64, 40
FEATURE_KEYS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _pose(rng) -> np.ndarray:
    a = rng.normal(0, 0.3, 3)
    th = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    T[:3, 3] = rng.normal(0, 2.0, 3)
    return T


def _features(rng) -> dict:
    return dict(xy=rng.uniform(0, 320, (N_SLOTS, 2)).astype(np.float32),
                response=rng.uniform(0, 50, N_SLOTS).astype(np.float32),
                angle=rng.uniform(-np.pi, np.pi, N_SLOTS).astype(np.float32),
                octave=rng.integers(0, 4, N_SLOTS).astype(np.int32),
                size=rng.uniform(31, 64, N_SLOTS).astype(np.float32),
                desc=rng.integers(0, 2**32, (N_SLOTS, 8), dtype=np.uint64).astype(np.uint32),
                valid=rng.uniform(size=N_SLOTS) < 0.9)


@pytest.fixture(scope="module")
def maps():
    """(JAX map, the port's copy of it on the CPU)."""
    rng = np.random.default_rng(5)
    m = jmap.Map()
    kfs = []
    for r in range(N_KF):
        f = _features(rng)
        kf = jmap.KeyFrame(features=[JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})], timestamp=0.1 * r)
        kf.update_pose(_pose(rng))
        m.add_keyframe(kf)
        kfs.append(kf)
    mps = []
    for i in range(N_MP):
        desc = None if i % 5 == 0 else rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        mp = jmap.MapPoint(rng.normal(0, 5, 3), color=rng.integers(0, 256, 3).astype(np.uint8), descriptor=desc)
        m.add_map_point(mp)
        mps.append(mp)
    for i, mp in enumerate(mps):
        for r in sorted(rng.choice(N_KF, size=1 + (i % 3 == 0), replace=False)):
            kfs[r].add_map_point(0, int(rng.integers(0, N_SLOTS)), mp)
    mps[7].set_bad()
    return m, interop.map_from_numpy(m.get_keyframes(), m.get_map_points(), device="cpu")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _canon(m) -> dict:
    """A map as plain arrays: keyframes in order, live landmarks in map
    order, observations as (keyframe row, camera, keypoint, landmark row)."""
    kfs = m.get_keyframes()
    mps = [mp for mp in m.get_map_points() if not mp.is_bad]
    row = {id(mp): i for i, mp in enumerate(mps)}
    feats = []
    for kf in kfs:
        f = {k: _np(getattr(kf.get_features(0), k)) for k in FEATURE_KEYS}
        f["desc"] = np.ascontiguousarray(f["desc"]).view(np.uint32)
        feats.append(f)
    return dict(
        kf_ids=[kf.keyframe_id for kf in kfs], frame_ids=[kf.id for kf in kfs], ts=[kf.timestamp for kf in kfs],
        poses=np.stack([kf.T_w2c for kf in kfs]), feats=feats,
        positions=np.stack([mp.position for mp in mps]),
        descs=[None if mp.descriptor is None else np.ascontiguousarray(mp.descriptor).view(np.uint32) for mp in mps],
        obs=sorted((r, c, k, row[id(mp)]) for r, kf in enumerate(kfs) for (c, k), mp in kf.map_points.items()
                   if id(mp) in row),
    )


def _assert_same_map(a, b):
    ca, cb = _canon(a), _canon(b)
    assert ca["kf_ids"] == cb["kf_ids"] and ca["frame_ids"] == cb["frame_ids"] and ca["ts"] == cb["ts"]
    np.testing.assert_array_equal(ca["poses"], cb["poses"])
    for fa, fb in zip(ca["feats"], cb["feats"]):
        for k in FEATURE_KEYS:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    np.testing.assert_array_equal(ca["positions"], cb["positions"])
    assert len(ca["descs"]) == len(cb["descs"])
    for da, db in zip(ca["descs"], cb["descs"]):
        assert (da is None) == (db is None)
        if da is not None:
            np.testing.assert_array_equal(da.reshape(-1), db.reshape(-1))
    assert ca["obs"] == cb["obs"]


@pytest.fixture(scope="module")
def files(maps, tmp_path_factory):
    d = tmp_path_factory.mktemp("ser")
    jser.save_map(maps[0], d / "jax.npz")
    tser.save_map(maps[1], d / "port.npz")
    return d / "jax.npz", d / "port.npz"


def test_files_have_the_same_keys_dtypes_and_arrays(files):
    with np.load(files[0]) as zj, np.load(files[1]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
        assert zt["kf0_desc"].dtype == np.uint32 and zt["mp_descs"].dtype == np.uint32


def _reset_ids(frame_base, keyframe):
    """Counters as in a new process."""
    frame_base._ids = itertools.count(0)
    keyframe._kf_ids = itertools.count(0)


def test_port_round_trip(maps, files):
    _reset_ids(tmap.frame.FrameBase, tmap.KeyFrame)
    loaded = tser.load_map(files[1], device="cpu")
    _assert_same_map(maps[1], loaded)
    kf = loaded.get_keyframes()[-1]
    assert tmap.Frame().id > max(k.id for k in loaded.get_keyframes())
    assert tmap.KeyFrame().keyframe_id > kf.keyframe_id
    # Host views come from the file: no copy from the features' device.
    np.testing.assert_array_equal(kf.descriptors(0), kf.get_features(0).desc.numpy())
    assert kf.get_features(0).desc.dtype == torch.int32


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_load(maps, files, direction):
    if direction == "jax_to_port":
        _assert_same_map(maps[1], tser.load_map(files[0], device="cpu"))
    else:
        _assert_same_map(maps[0], jser.load_map(files[1]))


def test_load_map_raises_without_a_card_or_a_file(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tser.load_map(files[1])
    with pytest.raises(FileNotFoundError):
        tser.load_map(tmp_path / "missing.npz", device="cpu")
    (tmp_path / "bad.npz").write_bytes(b"not a map")
    with pytest.raises(Exception):
        tser.load_map(tmp_path / "bad.npz", device="cpu")


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_text_matches_jax(maps, tmp_path, fmt):
    jfn, tfn = getattr(jser, f"save_trajectory_{fmt}"), getattr(tser, f"save_trajectory_{fmt}")
    jfn(maps[0].get_keyframes(), tmp_path / "jax.txt")
    tfn(maps[1].get_keyframes(), tmp_path / "port.txt")
    assert (tmp_path / "jax.txt").read_text() == (tmp_path / "port.txt").read_text()


def test_load_trajectory_tum_matches_jax(maps, tmp_path):
    tser.save_trajectory_tum(maps[1].get_keyframes(), tmp_path / "t.txt")
    ts_j, T_j = jser.load_trajectory_tum(tmp_path / "t.txt")
    ts_t, T_t = tser.load_trajectory_tum(tmp_path / "t.txt")
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-12)
    T_c2w = np.stack([np.linalg.inv(kf.T_w2c) for kf in maps[1].get_keyframes()])
    np.testing.assert_allclose(T_t, T_c2w, atol=2e-6)  # the text keeps 6 decimals


def _state_leaves(state):
    feats = [_np(getattr(state.ref_feats, k)) for k in FEATURE_KEYS]
    feats[5] = np.ascontiguousarray(feats[5]).view(np.uint32)
    rest = [_np(x) for x in (state.ref_landmarks, state.ref_has_landmark, state.T_w2c, state.T_rel)]
    arena = [_np(x) for x in (state.lm_pos, state.lm_desc, state.lm_valid) if x is not None]
    if arena:
        arena[1] = np.ascontiguousarray(arena[1]).view(np.uint32)
    return feats + rest + arena


@pytest.mark.parametrize("arena", [0, 16])
def test_track_state_round_trips_and_crosses(maps, tmp_path, arena):
    """The port's state saved and loaded again; the JAX package's state
    loads in the port (its key gives the generator's seed) and the port's
    in the JAX package's loader (the seed gives its key)."""
    rng = np.random.default_rng(3)
    kf = maps[1].get_keyframes()[0]
    pos, mask = kf.point_arrays(0)
    st = tpipeline.init_track_state(kf.get_features(0), pos, mask, _pose(rng), seed=77, local_map_size=arena,
                                    device="cpu")
    if arena:
        st = tpipeline.set_local_map(st, torch.randn(arena, 3), torch.randint(-2**31, 2**31 - 1, (arena, 8),
                                                                               dtype=torch.int32),
                                     torch.rand(arena) < 0.5)
    tser.save_track_state(st, tmp_path / "port.npz")
    back = tser.load_track_state(tmp_path / "port.npz", device="cpu")
    for a, b in zip(_state_leaves(st), _state_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert back.gen.initial_seed() == 77

    jst = jser.load_track_state(tmp_path / "port.npz")
    for a, b in zip(_state_leaves(st), _state_leaves(jst)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jst.key), np.asarray(jax.random.PRNGKey(77)))
    jser.save_track_state(jst, tmp_path / "jax.npz")
    from_jax = tser.load_track_state(tmp_path / "jax.npz", device="cpu")
    for a, b in zip(_state_leaves(st), _state_leaves(from_jax)):
        np.testing.assert_array_equal(a, b)
    assert from_jax.gen.initial_seed() == 77


def test_checkpointing_imports_neither_jax_nor_the_jax_package(files):
    """The port's serialization and both resumes load a map in a process
    where neither JAX nor ``visual_slam_tpu`` is imported."""
    code = (
        "import sys\n"
        "from visual_slam_tpu_torch.utils.serialization import load_map\n"
        "from visual_slam_tpu_torch.models import CompiledSLAM\n"
        "from visual_slam_tpu_torch.slam import SLAM\n"
        f"m = load_map({str(files[0])!r}, device='cpu')\n"
        f"assert m.num_keyframes() == {N_KF}\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'visual_slam_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
