"""Pipeline families (port of ``visual_slam_tpu.models.families``): thin
constructors over ``SLAM``, the tracking step and ``parallel`` with the
right defaults per mode. ``PipelinedVO`` belongs to ROADMAP M14."""
from __future__ import annotations

import numpy as np
import torch

from ..camera import PinholeCamera
from ..config import Config
from ..slam import SLAM
from ..utils.tree import as_numpy


def _base_config(num_features: int) -> Config:
    cfg = Config()
    cfg.feature.num_features = num_features
    return cfg


class MonoVO(SLAM):
    """Monocular SLAM (the flagship family), on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000, config: Config | None = None, **kwargs):
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "monocular"
        super().__init__(camera, cfg, **kwargs)


class StereoVO(SLAM):
    """Stereo SLAM: metric scale from the first frame, on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000, config: Config | None = None, **kwargs):
        if getattr(camera, "baseline", 0.0) <= 0:
            raise ValueError("StereoVO needs a camera with a positive baseline")
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "stereo"
        super().__init__(camera, cfg, **kwargs)


class RGBDVO(SLAM):
    """RGB-D SLAM: metric landmarks from depth maps, on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000, config: Config | None = None, **kwargs):
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "rgbd"
        super().__init__(camera, cfg, **kwargs)


class CompiledVO:
    """The fused device-resident frame-to-frame tracker (``pipeline.py``)
    with a minimal host API: feed frames, read poses. Keyframe and landmark
    management is the host's, through ``set_reference``. ``track_params``
    go to the step: with ``stereo=True`` and ``baseline``, ``track`` takes
    a (2, H, W) left/right pair."""

    def __init__(self, K: np.ndarray, num_features: int = 2000, device=None, **track_params):
        from ..pipeline import make_track_step

        self.K = np.asarray(K, np.float32)
        self.step = make_track_step(self.K, num_features=num_features, device=device, **track_params)
        self.num_features = num_features
        self.state = None
        self.poses: list[np.ndarray] = []

    def set_reference(self, features, landmarks, has_landmark, T_w2c=None, seed: int = 0):
        from ..pipeline import init_track_state, swap_reference

        if self.state is None:
            self.state = init_track_state(features, landmarks, has_landmark, np.eye(4) if T_w2c is None else T_w2c,
                                          seed=seed, device=self.step.K.device)
        else:
            self.state = swap_reference(self.state, features, landmarks, has_landmark)

    def track(self, img) -> dict:
        if self.state is None:
            raise RuntimeError("call set_reference() first")
        img = torch.as_tensor(img, dtype=torch.float32, device=self.step.K.device)
        self.state, out = self.step(self.state, img)
        T = as_numpy(out.T_w2c)
        self.poses.append(T)
        return {"T_w2c": T, "n_inliers": int(out.n_inliers), "n_matches": int(out.n_matches)}


class BatchedVO:
    """Data-parallel multi-sequence VO (``parallel.multiseq``): one step
    tracks a frame of each of B sequences, on the one device of ``mesh`` or
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, K: np.ndarray, mesh=None, num_features: int = 1000, device=None, **track_params):
        from ..parallel.multiseq import make_batched_vo

        self.mesh = mesh
        self.step = make_batched_vo(np.asarray(K, np.float32), mesh, num_features=num_features, device=device,
                                    **track_params)

    def track(self, states, imgs):
        """``(states, imgs (B, H, W)) -> (states, outs)`` with a batched state
        (``pipeline.stack_track_states``) on the step's device; (B, 2, H, W)
        pairs with ``stereo=True``."""
        return self.step(states, torch.as_tensor(imgs, dtype=torch.float32, device=states.T_w2c.device))
