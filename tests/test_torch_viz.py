"""The port's visualization (``visual_slam_tpu_torch.viz``) against the JAX
package's on the same state: a small map made from a seed with numpy
(two keyframes of 48 feature slots with images and random poses, 30
landmarks with colours, one bad, some seen by both keyframes), built with
the JAX classes and carried into the port with ``interop.map_from_numpy``.

Everything is exact: ``export_scene``'s arrays, ``save_ply``'s bytes,
``frustum_lines``, the ``draw_keypoints`` / ``draw_matches`` overlays with
OpenCV and with ``_HAS_CV2`` off in both packages, and ``show_keypoints`` /
``show_matches`` on the port's ``Frame`` and ``KeyFrame``."""
import jax.numpy as jnp
import numpy as np
import pytest

from visual_slam_tpu import map as jmap
from visual_slam_tpu import viz as jviz
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu.viz import feature_viz as jfv
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch import viz as tviz
from visual_slam_tpu_torch.viz import feature_viz as tfv

N_SLOTS, N_MP, H, W = 48, 30, 60, 80


def _pose(rng) -> np.ndarray:
    a = rng.normal(0, 0.3, 3)
    th = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    T[:3, 3] = rng.normal(0, 2.0, 3)
    return T


def _features(rng) -> JFeatures:
    return JFeatures(xy=jnp.asarray(rng.uniform(-2, W + 2, (N_SLOTS, 2)).astype(np.float32)),
                     response=jnp.asarray(rng.uniform(0, 50, N_SLOTS).astype(np.float32)),
                     angle=jnp.asarray(rng.uniform(-np.pi, np.pi, N_SLOTS).astype(np.float32)),
                     octave=jnp.asarray(rng.integers(0, 4, N_SLOTS).astype(np.int32)),
                     size=jnp.asarray(rng.uniform(31, 64, N_SLOTS).astype(np.float32)),
                     desc=jnp.asarray(rng.integers(0, 2**32, (N_SLOTS, 8), dtype=np.uint64).astype(np.uint32)),
                     valid=jnp.asarray(rng.uniform(size=N_SLOTS) < 0.8))


@pytest.fixture(scope="module")
def state():
    """(JAX map, the port's copy, a JAX frame, the port's copy of it)."""
    rng = np.random.default_rng(11)
    m = jmap.Map()
    kfs = []
    for r in range(2):
        kf = jmap.KeyFrame(features=[_features(rng)], timestamp=0.1 * r)
        kf.update_pose(_pose(rng))
        m.add_keyframe(kf)
        kfs.append(kf)
    mps = []
    for i in range(N_MP):
        mp = jmap.MapPoint(rng.normal(0, 5, 3), color=rng.integers(0, 256, 3).astype(np.uint8))
        m.add_map_point(mp)
        mps.append(mp)
    for i, mp in enumerate(mps):
        for r in ((0, 1) if i % 3 == 0 else (i % 2,)):
            kfs[r].add_map_point(0, i, mp)
    mps[6].set_bad()
    ours = interop.map_from_numpy(m.get_keyframes(), m.get_map_points(), device="cpu")
    for kf, okf in zip(kfs, ours.get_keyframes()):
        kf.images = okf.images = [rng.uniform(-20, 280, (H, W)).astype(np.float32)]
    frame = jmap.Frame(images=[rng.integers(0, 256, (H, W), dtype=np.uint8)], features=[_features(rng)])
    return m, ours, frame, interop.frame_from_numpy(frame, device="cpu")


@pytest.fixture(params=[True, False], ids=["cv2", "no_cv2"])
def cv2_mode(request, monkeypatch):
    """Both packages' overlays with OpenCV, then with ``_HAS_CV2`` off."""
    if not request.param:
        monkeypatch.setattr(jfv, "_HAS_CV2", False)
        monkeypatch.setattr(tfv, "_HAS_CV2", False)
    return request.param


def test_export_scene_arrays_are_equal(state):
    m, ours, _, _ = state
    a, b = tviz.MapVisualizer().export_scene(ours), jviz.MapVisualizer().export_scene(m)
    assert sorted(a) == sorted(b)
    for k in ("points", "colors", "keyframe_poses"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])
    assert a["keyframe_ids"] == b["keyframe_ids"]
    assert len(a["points"]) == N_MP - 1


def test_save_ply_is_byte_identical(state, tmp_path):
    m, ours, _, _ = state
    tviz.MapVisualizer().save_ply(ours, tmp_path / "port.ply")
    jviz.MapVisualizer().save_ply(m, tmp_path / "jax.ply")
    text = (tmp_path / "port.ply").read_bytes()
    assert text == (tmp_path / "jax.ply").read_bytes()
    assert f"element vertex {N_MP - 1}\n".encode() in text


def test_frustum_lines_are_equal(state):
    m, _, _, _ = state
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]])
    for kf in m.get_keyframes():
        for a, b in zip(tviz.frustum_lines(kf.T_w2c, K, W, H), jviz.frustum_lines(kf.T_w2c, K, W, H)):
            np.testing.assert_array_equal(a, b)


def test_draw_keypoints_and_matches_are_equal(cv2_mode):
    rng = np.random.default_rng(2)
    img1 = rng.uniform(-10, 300, (H, W)).astype(np.float32)
    img2 = rng.integers(0, 256, (H + 5, W - 7, 3), dtype=np.uint8)
    xy1 = rng.uniform(-3, W + 3, (25, 2))
    xy2 = rng.uniform(-3, W - 4, (25, 2))
    valid = rng.uniform(size=25) < 0.7
    ours, theirs = tviz.FeatureVisualizer(), jviz.FeatureVisualizer()
    for args in ((img1, xy1), (img1, xy1, valid), (img2, xy2, None, 3, (10, 200, 30))):
        a, b = ours.draw_keypoints(*args), theirs.draw_keypoints(*args)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    a, b = ours.draw_matches(img1, xy1, img2, xy2), theirs.draw_matches(img1, xy1, img2, xy2)
    assert a.shape == (2 * H + 5, W, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfv._hsv_colors(9), jfv._hsv_colors(9))


def test_show_keypoints_and_matches_are_equal(state, cv2_mode):
    """On the port's ``Frame`` (feature tensors read through their host
    copies) and ``KeyFrame`` pair, as on the JAX package's."""
    m, ours, frame, tframe = state
    a, b = tviz.MapVisualizer().show_keypoints(tframe), jviz.MapVisualizer().show_keypoints(frame)
    np.testing.assert_array_equal(a, b)
    K = np.eye(3)
    jk, tk = m.get_keyframes(), ours.get_keyframes()
    for i, j in ((0, 1), (1, 0)):
        a = tviz.MapVisualizer().show_matches(ours, tk[i], tk[j], K)
        b = jviz.MapVisualizer().show_matches(m, jk[i], jk[j], K)
        assert a.shape == (2 * H, W, 3)
        np.testing.assert_array_equal(a, b)
