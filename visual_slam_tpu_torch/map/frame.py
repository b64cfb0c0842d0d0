"""Frame: one multi-camera capture with its fixed-capacity feature block
(port of ``visual_slam_tpu.map.frame``).

Global id allocation, pose accessors in both directions, projection and
visibility helpers, per-camera image/keypoint/descriptor access. The
feature block is the port's ``Features``, whose tensors may live on the
card; the numpy views (``keypoints``, ``descriptors``, ``valid_mask``) are
copied to the host once per frame and cached. Descriptors are the port's
int32 words.
"""
from __future__ import annotations

import itertools
import threading
from typing import List, Optional

import numpy as np
import torch

from ..ops.detector import Features
from .pose import Pose


class FrameBase:
    _ids = itertools.count(0)
    _ids_lock = threading.Lock()

    def __init__(self, timestamp: float = 0.0, pose: Optional[Pose] = None, frame_id: int | None = None):
        # A given frame_id (a keyframe keeping its source frame's, a copy of
        # a map) takes nothing from the counter.
        if frame_id is None:
            with FrameBase._ids_lock:
                frame_id = next(FrameBase._ids)
        self.id = int(frame_id)
        self.timestamp = timestamp
        self._pose = pose.copy() if pose is not None else Pose()

    # -- pose accessors ----------------------------------------------------
    @property
    def pose(self) -> Pose:
        return self._pose

    @property
    def T_w2c(self) -> np.ndarray:
        return self._pose.T

    @property
    def T_c2w(self) -> np.ndarray:
        return self._pose.inverse().T

    @property
    def R_w2c(self) -> np.ndarray:
        return self._pose.R

    @property
    def t_w2c(self) -> np.ndarray:
        return self._pose.t

    @property
    def R_c2w(self) -> np.ndarray:
        return self._pose.R.T

    @property
    def t_c2w(self) -> np.ndarray:
        return -self._pose.R.T @ self._pose.t

    @property
    def camera_center(self) -> np.ndarray:
        return self.t_c2w

    def update_pose(self, T: np.ndarray | Pose) -> None:
        self._pose = T.copy() if isinstance(T, Pose) else Pose(T)

    def set_pose_Rt(self, R: np.ndarray, t: np.ndarray) -> None:
        self._pose = Pose.from_RT(R, t)

    def update_rotation(self, R: np.ndarray) -> None:
        self._pose = Pose.from_RT(R, self._pose.t)

    def update_translation(self, t: np.ndarray) -> None:
        self._pose = Pose.from_RT(self._pose.R, t)

    # -- geometry helpers --------------------------------------------------
    def transform_points(self, pts_w: np.ndarray) -> np.ndarray:
        return pts_w @ self._pose.R.T + self._pose.t

    def project_points(self, K: np.ndarray, pts_w: np.ndarray):
        pc = self.transform_points(pts_w)
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        uv = (pc[:, :2] / zs[:, None]) @ K[:2, :2].T + K[:2, 2]
        return uv, z

    def are_visible(
        self, K: np.ndarray, pts_w: np.ndarray, width: int, height: int, min_view_cos: float = 0.5
    ) -> np.ndarray:
        pc = self.transform_points(pts_w)
        z = pc[:, 2]
        n = np.linalg.norm(pc, axis=-1)
        vcos = z / np.maximum(n, 1e-9)
        uv, _ = self.project_points(K, pts_w)
        inb = (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        return inb & (z > 0) & (vcos > min_view_cos)


class Frame(FrameBase):
    """Single- or multi-camera frame carrying images + feature blocks.

    The monocular path uses cam 0 everywhere."""

    def __init__(
        self,
        images: List[np.ndarray] | None = None,
        images_gray: List[np.ndarray] | None = None,
        features: List[Features] | None = None,
        timestamp: float = 0.0,
        depth: np.ndarray | None = None,
        pose: Optional[Pose] = None,
        frame_id: int | None = None,
    ):
        super().__init__(timestamp=timestamp, pose=pose, frame_id=frame_id)
        self.images = images or []
        self.images_gray = images_gray or []
        self.features: List[Features] = features or []
        # Host copies of the (immutable) feature block: the tensors may live
        # on the card, and each read of one there is a device->host copy, so
        # it happens once per frame, not once per read.
        self._np_cache: dict = {}
        self.depth = depth
        # Per-keypoint depth measurements for cam 0 (stereo disparity /
        # RGB-D lookup), slot-aligned with features[0]; None on mono frames.
        self.kp_z: np.ndarray | None = None
        self.kp_z_valid: np.ndarray | None = None

    # -- per-camera accessors ----------------------------------------------
    def num_cameras(self) -> int:
        return max(len(self.images), len(self.features))

    def get_image(self, cam_id: int = 0) -> np.ndarray | None:
        return self.images[cam_id] if cam_id < len(self.images) else None

    def get_image_gray(self, cam_id: int = 0) -> np.ndarray | None:
        return self.images_gray[cam_id] if cam_id < len(self.images_gray) else None

    def get_features(self, cam_id: int = 0) -> Features | None:
        return self.features[cam_id] if cam_id < len(self.features) else None

    @property
    def image_left(self):
        return self.get_image(0)

    @property
    def image_right(self):
        return self.get_image(1)

    def _np_view(self, key: str, cam_id: int, arr) -> np.ndarray:
        c = self._np_cache.get((key, cam_id))
        if c is None:
            c = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
            self._np_cache[(key, cam_id)] = c
        return c

    def cache_host_features(self, feats, cam_id: int = 0) -> None:
        """Install host copies (numpy, fetched with the rest of a chunk's
        output) as the numpy views of camera ``cam_id``'s feature block, so
        reading them costs no device->host copy of its own."""
        for key in ("xy", "desc", "valid"):
            self._np_cache[(key, cam_id)] = np.asarray(getattr(feats, key))

    def keypoints(self, cam_id: int = 0) -> np.ndarray:
        """(K, 2) pixel coords (padded slots included; see valid mask)."""
        return self._np_view("xy", cam_id, self.features[cam_id].xy)

    def descriptors(self, cam_id: int = 0) -> np.ndarray:
        """(K, W) int32 descriptor words: W = 8 (binary) or 128 (float, bitcast)."""
        return self._np_view("desc", cam_id, self.features[cam_id].desc)

    def valid_mask(self, cam_id: int = 0) -> np.ndarray:
        return self._np_view("valid", cam_id, self.features[cam_id].valid)

    def num_features(self, cam_id: int = 0) -> int:
        return int(self.valid_mask(cam_id).sum()) if self.features else 0
