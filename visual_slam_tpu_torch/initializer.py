"""Map initialization (port of ``visual_slam_tpu.initializer``): the mono
two-view bootstrap and the stereo and RGB-D one-frame metric bootstraps.

Frame buffering, readiness gates (time gap, feature counts, grid
coverage), the essential-matrix + triangulation chain with parallax and
depth gates over every buffered reference frame, the best-supported pair
promoted to the first two keyframes with median-depth scale normalization,
landmarks with colors and observations, and a two-view BA polish. The
geometric stages run on the features' device; the RANSAC draws come from
one ``torch.Generator`` seeded with 7 (the JAX package's ``PRNGKey(7)``).

Stereo and RGB-D need one frame: the left keypoints matched in the right
image (``FeatureTracker.match``: kernel K2 and the fundamental filter),
gated to the same row and a positive disparity, or looked up in the depth
map, become metric landmarks; no parallax wait and no scale gauge. A
stereo pair is detected as one B = 2 batch (one K1 launch).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .config import Config
from .frontend.tracker import FeatureTracker
from .map import Frame, KeyFrame, Map, MapPoint
from .ops import epipolar as ep_ops
from .ops import triangulation as tri_ops
from .ops.projection import normalize_points
from .ops.stereo import backproject_np
from .tracking import detect_frame_features, frame_images
from .utils.tree import to_host


def check_feature_coverage(
    xy: np.ndarray, valid: np.ndarray, width: int, height: int,
    grid: int = 3, min_per_cell: int = 5, min_cell_fraction: float = 0.6,
) -> bool:
    """3x3 grid coverage gate."""
    pts = xy[valid]
    if len(pts) == 0:
        return False
    cx = np.clip((pts[:, 0] / width * grid).astype(int), 0, grid - 1)
    cy = np.clip((pts[:, 1] / height * grid).astype(int), 0, grid - 1)
    counts = np.zeros((grid, grid), int)
    np.add.at(counts, (cy, cx), 1)
    return (counts >= min_per_cell).mean() >= min_cell_fraction


class Initializer:
    def __init__(
        self,
        camera: Camera,
        config: Config,
        feature_tracker: FeatureTracker,
        slam_map: Map,
        logger: Optional[logging.Logger] = None,
    ):
        self.camera = camera
        self.config = config
        self.tracker = feature_tracker
        self.map = slam_map
        self.logger = logger or logging.getLogger("initializer")
        self.initialized = False
        self.min_inliers = config.initialization.min_inliers
        # Relaxation floor: never tightens a deliberately low threshold.
        self._min_inliers_floor = min(30, self.min_inliers)
        self._n_failures = 0
        self.device = feature_tracker.device
        self._gen = torch.Generator(device=self.device).manual_seed(7)

    def add_frame(self, images, timestamp: float, depth=None) -> Frame:
        images, grays = frame_images(images, depth, self.config.camera.sensor_type)
        feats = detect_frame_features(self.tracker, self.camera, grays)
        frame = Frame(images=images, images_gray=grays, features=feats, timestamp=timestamp, depth=depth)
        self.map.add_frame(frame)
        return frame

    def initialize(self, images, timestamp: float, depth=None) -> bool:
        sensor = self.config.camera.sensor_type
        boot = {"monocular": self._initialize_mono, "stereo": self._initialize_stereo,
                "rgbd": self._initialize_rgbd}.get(sensor)
        if boot is None:
            raise ValueError(f"unknown sensor type {sensor!r}")
        return boot(self.add_frame(images, timestamp, depth))

    def _initialize_stereo(self, frame: Frame) -> bool:
        """Metric bootstrap from one stereo pair: left/right match, rectified
        row gate (2 px) and disparity > 0.1 px, depth = bf / disparity inside
        the initializer's depth range."""
        fl, fr = frame.get_features(0), frame.get_features(1)
        bf = float(getattr(self.camera, "bf", 0.0))
        if fl is None or fr is None or bf <= 0:
            return False
        res = self.tracker.match(fl, fr)
        ti, ok = to_host((res.train_idx, res.valid))
        xy_l, xy_r = frame.keypoints(0), frame.keypoints(1)
        slots = np.nonzero(ok)[0]
        xl, xr = xy_l[slots], xy_r[ti[slots]]
        disp = xl[:, 0] - xr[:, 0]
        keep = (np.abs(xl[:, 1] - xr[:, 1]) <= 2.0) & (disp > 0.1)
        z = bf / np.where(keep, disp, 1.0)
        icfg = self.config.initialization
        keep &= (icfg.min_depth < z) & (z < icfg.max_depth)
        return self._bootstrap_keyframe(frame, slots[keep], z[keep], "stereo")

    def _initialize_rgbd(self, frame: Frame) -> bool:
        """Metric bootstrap from one depth frame: the depth map's pixel
        nearest each valid keypoint, inside the initializer's depth range."""
        if frame.get_features(0) is None or frame.depth is None:
            return False
        depth = frame.depth
        H, W = depth.shape[:2]
        slots = np.nonzero(frame.valid_mask(0))[0]
        xy = frame.keypoints(0)[slots]
        ui, vi = np.round(xy[:, 0]).astype(np.int64), np.round(xy[:, 1]).astype(np.int64)
        keep = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        z = np.zeros(len(slots))
        z[keep] = depth[vi[keep], ui[keep]]
        icfg = self.config.initialization
        keep &= (icfg.min_depth < z) & (z < icfg.max_depth)
        return self._bootstrap_keyframe(frame, slots[keep], z[keep], "rgbd")

    def _bootstrap_keyframe(self, frame: Frame, slots: np.ndarray, z: np.ndarray, kind: str) -> bool:
        """The frame becomes the first keyframe with a landmark at each of
        ``slots`` (camera 0 keypoints) at depth ``z``, if there are at least
        ``min_inliers`` of them."""
        if len(slots) < self.min_inliers:
            return False
        xy = frame.keypoints(0)
        p_w = backproject_np(self.camera.Kinv, frame.R_c2w, frame.t_c2w, xy[slots], z)
        kf = KeyFrame.from_frame(frame)
        img = frame.get_image(0)
        for i, p in zip(slots, p_w):
            mp = MapPoint(p, color=_pixel_color(img, xy[i]))
            kf.add_map_point(0, int(i), mp)
            self.map.add_map_point(mp)
        self.map.add_keyframe(kf)
        self.logger.info("%s init: %d landmarks from one frame", kind, len(slots))
        self.initialized = True
        return True

    def _initialize_mono(self, frame_cur: Frame) -> bool:
        """Evaluates every buffered reference frame and initializes from the
        best-supported pair (surviving points x median parallax)."""
        frames = self.map.get_frames()
        icfg = self.config.initialization
        Kinv = torch.as_tensor(self.camera.Kinv, dtype=torch.float32).to(self.device)
        candidates = []
        for frame_ref in frames[:-1]:
            if not self._can_initialize(frame_ref, frame_cur):
                continue
            res = self.tracker.match(frame_cur.get_features(0), frame_ref.get_features(0))
            n_matches = res.n_matches
            if n_matches < self.min_inliers:
                self.logger.debug("init: %d matches < %d", n_matches, self.min_inliers)
                continue
            x_cur = normalize_points(Kinv, res.features1.xy)
            x_ref = normalize_points(Kinv, res.features2.xy[res.train_idx])
            motion = ep_ops.estimate_motion_2d2d(x_ref, x_cur, res.valid, self._gen,
                                                 n_hyp=icfg.essential_hypotheses, thresh=icfg.essential_threshold)
            n_inl = int(motion["n_inliers"])
            if n_inl < self.min_inliers:
                self.logger.debug("init: %d essential inliers < %d", n_inl, self.min_inliers)
                self._register_failure()
                continue
            # World pose of cur from ref (T maps ref camera -> cur camera).
            T_ref = torch.as_tensor(frame_ref.T_w2c, dtype=torch.float32).to(self.device)
            T_cur = motion["T"] @ T_ref
            med_par = float(tri_ops.median_ray_parallax(motion["R"], x_ref, x_cur, motion["inliers"]))
            if np.rad2deg(med_par) < icfg.min_parallax_deg / 2.0:
                self.logger.debug("init: median parallax %.3fdeg too low", np.rad2deg(med_par))
                self._register_failure()
                continue
            pts3d, w_ok = tri_ops.triangulate_dlt(tri_ops.projection_from_T(T_ref), tri_ops.projection_from_T(T_cur),
                                                  x_ref, x_cur)
            good = motion["inliers"] & w_ok
            good = good & tri_ops.depth_mask(T_ref, T_cur, pts3d, icfg.min_depth, icfg.max_depth)
            good = good & (tri_ops.parallax_angles(T_ref, T_cur, pts3d) >= np.deg2rad(icfg.min_parallax_deg))
            T_cur_np, pts_np, good_np = to_host((T_cur, pts3d, good))
            n_good = int(good_np.sum())
            if n_good < self.min_inliers:
                self.logger.debug("init: %d surviving points < %d", n_good, self.min_inliers)
                self._register_failure()
                continue
            candidates.append({
                "frame_ref": frame_ref, "res": res, "T_cur": T_cur_np, "pts3d": pts_np, "good": good_np,
                "n_good": n_good, "parallax": med_par, "score": n_good * med_par,
            })
        if not candidates:
            return False
        best = max(candidates, key=lambda c: c["score"])
        frame_cur.update_pose(np.asarray(best["T_cur"], np.float64))
        self._finalize_initialization(best["frame_ref"], frame_cur, best["res"], best["pts3d"], best["good"])
        self.logger.info("init: success with %d points (parallax %.2fdeg, %d candidate pairs)",
                         best["n_good"], np.rad2deg(best["parallax"]), len(candidates))
        return True

    def _can_initialize(self, frame_ref: Frame, frame_cur: Frame) -> bool:
        icfg = self.config.initialization
        if frame_cur.timestamp - frame_ref.timestamp < icfg.min_dt:
            return False
        for f in (frame_ref, frame_cur):
            if f.get_features(0) is None or int(f.valid_mask(0).sum()) < self.min_inliers:
                return False
        return check_feature_coverage(frame_cur.keypoints(0), frame_cur.valid_mask(0),
                                      self.camera.width, self.camera.height)

    def _register_failure(self) -> None:
        """Adaptive threshold relaxation toward the floor."""
        self._n_failures += 1
        if self._n_failures % 5 == 0:
            self.min_inliers = max(self._min_inliers_floor, self.min_inliers - 10)
            self.logger.info("init: relaxing min_inliers to %d", self.min_inliers)

    def _finalize_initialization(self, frame_ref: Frame, frame_cur: Frame, res, pts3d: np.ndarray,
                                 good: np.ndarray) -> None:
        # Scale normalization: median landmark depth in the ref camera -> 1.
        sel = np.nonzero(good)[0]
        pts_sel = pts3d[sel]
        z_ref = pts_sel @ frame_ref.R_w2c[2] + frame_ref.t_w2c[2]
        med = np.median(z_ref[z_ref > 0]) if (z_ref > 0).any() else 1.0
        if med > 1e-6:
            scale = 1.0 / med
            pts_sel = pts_sel * scale
            for fr in (frame_ref, frame_cur):
                T = fr.T_w2c.copy()
                T[:3, 3] *= scale
                fr.update_pose(T)

        kf_ref = KeyFrame.from_frame(frame_ref)
        kf_cur = KeyFrame.from_frame(frame_cur)
        self.map.add_keyframe(kf_ref)
        self.map.add_keyframe(kf_cur)

        train_idx = to_host(res.train_idx)
        img_ref = frame_ref.get_image(0)
        xy_ref = frame_ref.keypoints(0)
        desc_ref = frame_ref.descriptors(0)
        for n, i_cur in enumerate(sel):
            i_ref = int(train_idx[i_cur])
            mp = MapPoint(pts_sel[n], color=_pixel_color(img_ref, xy_ref[i_ref]), descriptor=desc_ref[i_ref])
            kf_ref.add_map_point(0, i_ref, mp)
            kf_cur.add_map_point(0, int(i_cur), mp)
            self.map.add_map_point(mp)

        err_before = self.map.compute_mean_reprojection_error(self.camera.K)
        if getattr(self, "optimizer", None) is not None:
            self.map.optimize_initial(self.optimizer, [kf_ref, kf_cur])
            err_after = self.map.compute_mean_reprojection_error(self.camera.K)
            self.logger.info("init BA: reproj %.3fpx -> %.3fpx", err_before, err_after)
        self.initialized = True


def _pixel_color(img: np.ndarray | None, xy: np.ndarray) -> np.ndarray:
    if img is None:
        return np.array([128, 128, 128], np.uint8)
    x = int(np.clip(xy[0], 0, img.shape[1] - 1))
    y = int(np.clip(xy[1], 0, img.shape[0] - 1))
    px = img[y, x]
    if np.ndim(px) == 0:
        return np.array([px, px, px], np.uint8)
    return np.asarray(px, np.uint8)
