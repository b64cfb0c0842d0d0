"""Camera projection math and ``undistort_features`` of the torch port
against the JAX package on the CPU, in float32 (tolerance 1e-5 relative,
1e-6 absolute; bounds masks exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.camera import PinholeCamera as JCamera
from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops import projection as jp
from visual_slam_tpu.ops.detector import Features as JFeatures
from visual_slam_tpu.tracking import undistort_features as j_undistort_features
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.interop import features_from_numpy
from visual_slam_tpu_torch.ops import projection as tp
from visual_slam_tpu_torch.tracking import undistort_features

K = np.array([[420.0, 0, 310.0], [0, 415.0, 245.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.28, 0.07, 1e-3, -5e-4, 0.01], np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    T = np.asarray(jlie.make_T(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])), jnp.asarray([0.3, -0.1, 0.5])))
    X = np.stack([rng.uniform(-4, 4, 50), rng.uniform(-3, 3, 50), rng.uniform(-1, 12, 50)], 1).astype(np.float32)
    uv = rng.uniform(-20, 660, (50, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 9, 50).astype(np.float32)
    return T, X, uv, depth


def _close(a, b):
    np.testing.assert_allclose(a.numpy() if torch.is_tensor(a) else a, np.asarray(b), rtol=1e-5, atol=1e-6)


def test_projection_functions_match_jax(data):
    T, X, uv, depth = data
    Kinv = np.linalg.inv(K).astype(np.float32)
    t = torch.from_numpy
    _close(tp.add_ones(t(uv)), jp.add_ones(uv))
    _close(tp.normalize_points(t(Kinv), t(uv)), jp.normalize_points(Kinv, uv))
    _close(tp.denormalize_points(t(K), t(uv) / 500), jp.denormalize_points(K, uv / 500))
    _close(tp.transform_points(t(T), t(X)), jp.transform_points(T, X))
    for a, b in zip(tp.project_points(t(K), t(T), t(X)), jp.project_points(K, T, X)):
        _close(a, b)
    _close(tp.backproject(t(Kinv), t(uv), t(depth)), jp.backproject(Kinv, uv, depth))
    _close(tp.unproject_points(t(Kinv), t(uv)), jp.unproject_points(Kinv, uv))
    for margin in (0.0, 8.0):
        np.testing.assert_array_equal(tp.are_in_image(t(uv), 640, 480, margin).numpy(),
                                      np.asarray(jp.are_in_image(uv, 640, 480, margin)))
    _close(tp.reprojection_errors(t(K), t(T), t(X), t(uv)), jp.reprojection_errors(K, T, X, uv))
    _close(tp.view_cos(t(T), t(X)), jp.view_cos(T, X))
    np.testing.assert_allclose(tp.fov2focal(1.1, 640.0), float(jp.fov2focal(1.1, 640.0)), rtol=1e-6)
    np.testing.assert_allclose(tp.focal2fov(420.0, 640.0), float(jp.focal2fov(420.0, 640.0)), rtol=1e-6)


def test_distortion_round_trip_matches_jax(data):
    _, _, uv, _ = data
    Kinv = np.linalg.inv(K).astype(np.float32)
    xy = np.asarray(jp.normalize_points(Kinv, uv)) * 0.6
    t = torch.from_numpy
    _close(tp.distort_normalized(t(DIST), t(xy)), jp.distort_normalized(DIST, xy))
    xy_d = np.asarray(jp.distort_normalized(DIST, xy))
    _close(tp.undistort_normalized(t(DIST), t(xy_d)), jp.undistort_normalized(DIST, xy_d))
    _close(tp.undistort_pixels(t(K), t(Kinv), t(DIST), t(uv)), jp.undistort_pixels(K, Kinv, DIST, uv))


@pytest.mark.parametrize("dist", [None, DIST])
def test_undistort_features_matches_jax(data, dist):
    _, _, uv, _ = data
    n = uv.shape[0]
    f = JFeatures(xy=jnp.asarray(uv), response=jnp.ones(n), angle=jnp.zeros(n), octave=jnp.zeros(n, jnp.int32),
                  size=jnp.ones(n), desc=jnp.zeros((n, 8), jnp.uint32), valid=jnp.ones(n, bool))
    kw = {} if dist is None else {"D": dist}
    ref = j_undistort_features(f, JCamera(width=640, height=480, K=K, **kw))
    got = undistort_features(features_from_numpy(f), PinholeCamera(width=640, height=480, K=K, **kw))
    _close(got.xy, ref.xy)
