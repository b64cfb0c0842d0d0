"""Helpers of the facade parity tests (tests/test_torch_{tracking,
local_mapping,handlers}.py): a JAX ``SLAM`` run on test_slam_e2e.py's world,
the port's ``SLAM`` continued from its state (``interop.install_slam_state``),
frames with identical features in both packages, and the JAX package's
RANSAC draws fed to the port's matcher and PnP."""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from render import render_sequence
from test_slam_e2e import small_config as jax_small_config
from visual_slam_tpu.camera import PinholeCamera as JCamera
from visual_slam_tpu.ops import epipolar as jepi
from visual_slam_tpu.slam import SLAM as JSLAM
from visual_slam_tpu_torch import interop
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.map import Frame
from visual_slam_tpu_torch.slam import SLAM


def world(n_frames=12, seed=42, step=0.35):
    """(frames, Ts_gt, K) of test_slam_e2e.py's world."""
    frames, Ts, K, _ = render_sequence(np.random.default_rng(seed), n_frames=n_frames, step=step)
    return frames, Ts, K


def configs(**changes):
    """(JAX config, the port's equal config) from ``small_config`` with
    ``section__field`` changes."""
    jcfg = jax_small_config()
    for key, v in changes.items():
        section, field = key.split("__")
        setattr(getattr(jcfg, section), field, v)
    return jcfg, Config.from_dict(jcfg.to_dict())


def jax_slam(frames, K, jcfg, n_track: int) -> JSLAM:
    """The JAX facade after tracking the first ``n_track`` frames."""
    slam = JSLAM(JCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K), jcfg)
    for i in range(n_track):
        slam.track([frames[i]], timestamp=i * 0.1)
    return slam


def port_from(js: JSLAM, frames, K, cfg) -> SLAM:
    """The port's facade (CPU) continuing from ``js``'s state."""
    ts = SLAM(PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K), cfg, device="cpu")
    jt = js.tracking
    interop.install_slam_state(
        ts, js.map.get_keyframes(), js.map.get_map_points(), jt.reference_keyframe.keyframe_id,
        jt.last_frame.T_w2c, jt.motion_model, jt.last_keyframe_frame_id, jt.last_frame.id,
        gauge_log=js.map._gauge_log,
    )
    return ts


def shared_frames(js: JSLAM, ts: SLAM, img, timestamp):
    """A JAX frame detected on ``img`` and the port's frame holding the same
    features; both at the JAX facade's predicted pose, with one frame id."""
    jt = js.tracking
    jf = jt._create_frame([img], timestamp, None)
    jt._predict_pose(jf)
    tf = Frame(images=[img], images_gray=[img], features=[interop.features_from_numpy(jf.get_features(0), "cpu")],
               timestamp=timestamp, frame_id=jf.id)
    tf.update_pose(np.array(jf.T_w2c))
    ts.map.add_frame(tf)
    ts.tracking.current_frame = tf
    return jf, tf


@contextlib.contextmanager
def shared_match_draws(jtracker, ttracker):
    """Every fundamental-filter RANSAC the JAX tracker runs records its
    minimal sets, and the port's tracker replays them in order (the packages
    make the same match calls in the same order). Yields the draw queue."""
    queue = []
    orig_fund, orig_match = jepi.ransac_fundamental, ttracker.match

    def fund(x1, x2, mask, key, n_hyp=128, thresh=1.0):
        queue.append(torch.from_numpy(np.array(jepi._sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 8))))
        return orig_fund(x1, x2, mask, key, n_hyp=n_hyp, thresh=thresh)

    def match(f1, f2, sample_idx=None):
        return orig_match(f1, f2, sample_idx=queue.pop(0) if sample_idx is None else sample_idx)

    jepi.ransac_fundamental = fund
    ttracker.match = match
    try:
        yield queue
    finally:
        jepi.ransac_fundamental = orig_fund
        del ttracker.match


def pnp_draws(jtracking, pair_valid, n_hyp: int) -> torch.Tensor:
    """The minimal sets the JAX ``Tracking._optimize_pose`` draws next
    (without advancing its key)."""
    _, sub = jax.random.split(jtracking._key)
    return torch.from_numpy(np.array(jepi._sample_minimal_sets(sub, jnp.asarray(pair_valid), n_hyp, 6)))
