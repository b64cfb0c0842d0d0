"""Default monocular strategy: local-map association + RANSAC-PnP (port of
``visual_slam_tpu.trackingalgorithm.mono_tracking``)."""
from __future__ import annotations

import numpy as np

from .base import BaseTrackingAlgorithm


class MonoTracking(BaseTrackingAlgorithm):
    def __init__(self, n_local_keyframes: int = 3, use_guided: bool = True, min_guided_candidates: int = 30):
        self.n_local_keyframes = n_local_keyframes
        self.use_guided = use_guided
        self.min_guided_candidates = min_guided_candidates

    def track_frame(self, tracking, frame) -> dict:
        # Primary: projection-guided local-map search against the predicted
        # pose (K3). Fallback: brute multi-keyframe descriptor matching (K2)
        # when guided association is thin.
        info = {}
        pts3d = xy_obs = pair_valid = None
        if self.use_guided:
            guided = tracking._track_guided(frame, n_keyframes=self.n_local_keyframes)
            if guided is not None:
                pts3d, xy_obs, pair_valid = guided["pts3d"], guided["xy"], guided["valid"]
                info["n_guided"] = int(pair_valid.sum())
                info["guided"] = guided
        match_res = None
        if pair_valid is None or pair_valid.sum() < self.min_guided_candidates:
            match_res, pts3d, xy_obs, pair_valid = tracking._track_local_map(frame, n_keyframes=self.n_local_keyframes)
            info.pop("guided", None)
        n_candidates = int(np.asarray(pair_valid).sum())
        info.update({"n_matches": match_res.n_matches if match_res else n_candidates, "n_3d2d": n_candidates,
                     "match_res": match_res})
        if n_candidates >= 6:
            info.update(tracking._optimize_pose(frame, pts3d, xy_obs, pair_valid))
        else:
            info.update({"ok": False, "n_inliers": 0, "inlier_ratio": 0.0})

        # Guided associations can be poisoned when the motion prediction is
        # off: before declaring failure, retry with the brute path.
        if info.get("guided") is not None and not tracking._is_tracking_good(info):
            match_res, pts3d_b, xy_b, valid_b = tracking._track_local_map(frame, n_keyframes=self.n_local_keyframes)
            n_b = int(np.asarray(valid_b).sum())
            if n_b >= 6:
                retry = tracking._optimize_pose(frame, pts3d_b, xy_b, valid_b)
                if retry.get("n_inliers", 0) > info.get("n_inliers", 0):
                    info.pop("guided", None)
                    info.update(retry)
                    info.update({"n_matches": match_res.n_matches, "n_3d2d": n_b, "match_res": match_res})
        return info
