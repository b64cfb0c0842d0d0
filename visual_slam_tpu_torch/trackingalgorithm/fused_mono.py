"""Fused monocular strategy (port of
``visual_slam_tpu.trackingalgorithm.fused_mono``): the per-frame device
work (detect with K1, projection-guided association with K3, RANSAC-PnP,
the predicted-pose fallback) is one ``pipeline.FrameStep`` call with one
fetch of its scalars and masks, instead of three or four round trips. The
brute descriptor path stays as a host-side retry for frames where the
motion prediction poisons the guided associations. Its RANSAC draws come
from a ``torch.Generator`` on the device seeded 31 (the JAX package's
``PRNGKey(31)``). Keypoints of a distorted camera are undistorted inside
the step. A stereo frame goes in as its (2, H, W) pair (one detect batch),
an RGB-D frame as (gray, depth); the step measures the keypoints' depths
and solves the depth-aware PnP, and the frame keeps them (``kp_z``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..tracking import frame_images
from ..utils.tree import to_host
from .base import BaseTrackingAlgorithm
from .mono_tracking import MonoTracking


class FusedMonoTracking(BaseTrackingAlgorithm):
    def __init__(self, n_local_keyframes: int = 3, landmark_cap: int | None = None):
        self.n_local_keyframes = n_local_keyframes
        self.landmark_cap = landmark_cap  # None -> scales with the feature budget
        self._step = None
        self._gen = None
        self._stereo = False
        self._rgbd = False
        self._fallback = MonoTracking(n_local_keyframes, use_guided=False)

    def _get_step(self, tracking):
        if self._step is None:
            from ..pipeline import make_frame_step

            cam = tracking.camera
            fcfg = tracking.config.feature
            tcfg = tracking.config.tracking
            lcfg = tracking.config.local_mapping
            sensor = tracking.config.camera.sensor_type
            self._stereo = (sensor == "stereo" and tcfg.use_depth_residual
                            and float(getattr(cam, "baseline", 0.0)) > 0)
            self._rgbd = sensor == "rgbd" and tcfg.use_depth_residual
            self._step = make_frame_step(
                cam.K, float(cam.width), float(cam.height), num_features=fcfg.num_features,
                fast_threshold=fcfg.fast_threshold, n_levels=fcfg.num_pyramid_levels, scale=fcfg.scale_factor,
                grid=fcfg.grid_cells, pnp_hypotheses=tcfg.pnp_hypotheses, pnp_threshold_px=tcfg.pnp_threshold_px,
                dist=cam.D if cam.has_distortion else None, stereo=self._stereo, rgbd=self._rgbd,
                baseline=float(getattr(cam, "baseline", 0.0)) if self._stereo else tcfg.rgbd_virtual_baseline,
                stereo_row_tolerance=tcfg.stereo_row_tolerance, min_depth=lcfg.min_depth,
                max_depth=lcfg.max_depth, depth_scale=tcfg.depth_scale, device=tracking.device,
            )
            self._gen = torch.Generator(device=tracking.device).manual_seed(31)
        return self._step

    def track_frame(self, tracking, frame) -> dict:  # pragma: no cover - unused
        return self._fallback.track_frame(tracking, frame)

    def process(self, tracking, images, timestamp, depth):
        from ..map import Frame

        step = self._get_step(tracking)
        dev = tracking.device
        imgs, grays = frame_images(images, depth, tracking.config.camera.sensor_type)
        pos, desc, lvalid, landmarks = tracking._local_landmark_block(self.n_local_keyframes, cap=self.landmark_cap)
        T_pred = (tracking.motion_model @ tracking.last_frame.T_w2c if tracking.last_frame is not None
                  else np.eye(4))
        if self._stereo:
            img = np.stack([np.asarray(g, np.float32) for g in grays[:2]])
        elif self._rgbd:
            img = np.stack([np.asarray(grays[0], np.float32), np.asarray(depth, np.float32)])
        else:
            img = np.asarray(grays[0], np.float32)
        out = step(
            torch.as_tensor(img).to(dev), tracking._t(pos), torch.from_numpy(desc).to(dev),
            tracking._t(lvalid, torch.bool), tracking._t(T_pred), self._gen,
        )
        feats = [out["features"]] + ([out["features_right"]] if "features_right" in out else [])
        frame = Frame(images=imgs, images_gray=grays, features=feats, timestamp=timestamp, depth=depth)

        # One fetch for the decision, the depths and the frame's host feature views.
        depths = (out["kp_z"], out["kp_z_valid"]) if "kp_z" in out else None
        T, n_inl, ok, pair_valid, lm_idx, pnp_inl, depths, host_feats = to_host(
            (out["T_w2c"], out["n_inliers"], out["ok"], out["pair_valid"], out["lm_idx"], out["pnp_inliers"],
             depths, feats))
        for cam_id, hf in enumerate(host_feats):
            frame.cache_host_features(hf, cam_id)
        if depths is not None:
            # The step's depths: reused by the PnP retries and the keyframe handlers.
            frame.kp_z, frame.kp_z_valid = depths
        tracking.map.add_frame(frame)
        tracking.current_frame = frame
        n_candidates = int(pair_valid.sum())
        n_inl = int(n_inl)
        info = {
            "n_guided": n_candidates, "n_matches": n_candidates, "n_3d2d": n_candidates, "n_inliers": n_inl,
            "inlier_ratio": n_inl / max(n_candidates, 1), "ok": bool(ok), "pnp_inliers": pnp_inl,
            "guided": {"valid": pair_valid, "lm_idx": lm_idx, "landmarks": landmarks}, "match_res": None,
        }
        if info["ok"]:
            frame.update_pose(np.asarray(T, np.float64))

        # Host-side retry with brute descriptor matching when the fused
        # (prediction-gated) association failed the quality gates.
        if not tracking._is_tracking_good(info):
            match_res, pts3d_b, xy_b, valid_b = tracking._track_local_map(frame, n_keyframes=self.n_local_keyframes)
            n_b = int(np.asarray(valid_b).sum())
            if n_b >= 6:
                retry = tracking._optimize_pose(frame, pts3d_b, xy_b, valid_b)
                if retry.get("n_inliers", 0) > info.get("n_inliers", 0):
                    info.pop("guided", None)
                    info.update(retry)
                    info.update({"n_matches": match_res.n_matches, "n_3d2d": n_b, "match_res": match_res,
                                 "inlier_ratio": retry["n_inliers"] / max(n_b, 1)})
        return frame, info
