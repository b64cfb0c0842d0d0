"""Per-frame tracking state machine (port of ``visual_slam_tpu.tracking``).

State dispatch, first-frame intake and the two-view bootstrap hand-off
(``Initializer``), steady-state tracking through the pluggable strategy
(``trackingalgorithm``: projection-guided association against the local
map with kernel K3, the brute multi-keyframe descriptor fallback with K2,
RANSAC-PnP with a Gauss-Newton polish), the tracking-quality gates, the
keyframe decision and promotion, the constant-velocity motion model, the
mono gauge catch-up for the threaded mode (``Map.gauge_version``) and
relocalization against recent keyframes plus a global-signature shortlist
of the whole map.

Stereo and RGB-D frames carry a depth per keypoint (``_measure_depth``:
the row-gated left/right match of ``ops.stereo``, or the depth map's
pixel), and the pose solve then adds their normalized-disparity residual
(``ops.pnp.ransac_pnp_depth``); a stereo pair is detected as one B = 2
batch, so kernel K1 launches once a frame. The stereo and RGB-D bootstraps
take one frame (``Initializer``).

The device work runs on ``device`` (the card unless the caller asks for
the CPU); the host decisions read counts fetched every frame, by design.
The RANSAC draws come from a ``torch.Generator`` on the device seeded 13
(the JAX package's ``PRNGKey(13)``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .config import Config
from .frontend.tracker import FeatureTracker
from .map import Frame, KeyFrame, Map
from .ops.detector import Features
from .ops.lie import rotation_angle
from .ops.pnp import _reproj_err2, ransac_pnp, refine_pose_gn
from .ops.projection import normalize_points, undistort_pixels
from .ops.stereo import depth_settings, measure_keypoint_depths
from .state import State
from .utils.device import default_device
from .utils.tree import to_host


class Tracking:
    def __init__(
        self,
        camera: Camera,
        config: Config,
        feature_tracker: FeatureTracker,
        slam_map: Map,
        local_mapping,
        optimizer=None,
        logger: Optional[logging.Logger] = None,
        slam=None,
        device=None,
    ):
        from .initializer import Initializer
        from .trackingalgorithm import FusedMonoTracking, MonoTracking

        if config.camera.sensor_type not in ("monocular", "stereo", "rgbd"):
            raise ValueError(f"unknown sensor type {config.camera.sensor_type!r}")
        self.camera = camera
        self.config = config
        self.tracker = feature_tracker
        self.map = slam_map
        self.local_mapping = local_mapping
        self.optimizer = optimizer
        self.logger = logger or logging.getLogger("tracking")
        self.device = default_device(device)
        self._slam = slam  # the state owner
        self._state = State.NO_IMAGES_YET

        self.initializer = Initializer(camera, config, feature_tracker, slam_map, logger=self.logger)
        self.initializer.optimizer = optimizer

        self.current_frame: Frame | None = None
        self.last_frame: Frame | None = None
        self.reference_keyframe: KeyFrame | None = None
        self.motion_model = np.eye(4)  # T_rel = T_cur @ inv(T_last), w2c
        self.last_keyframe_frame_id = -1
        self._gen = torch.Generator(device=self.device).manual_seed(13)
        self._K = torch.as_tensor(np.asarray(camera.K, np.float32)).to(self.device)
        self._Kinv = torch.as_tensor(np.asarray(camera.Kinv, np.float32)).to(self.device)
        self.last_track_info: dict = {}
        # Mono-gauge versioning (threaded mode): the gauge the carried state
        # (last_frame pose, motion model) is expressed in, and the gauge of
        # the latest landmark gather. See Map.gauge_version.
        self._gauge_seen = 0
        self._gather_gauge_version = 0
        # Relocalization place-recognition cache: kf_id -> (V,) signature.
        self._reloc_sig_table: dict[int, np.ndarray] = {}
        # (ref_kf_id, T_w2c at gather time): a concurrent BA writeback may
        # move the reference between this frame's gather and its promotion;
        # the keyframe is then re-anchored through the reference's delta.
        self._gather_ref_snap: tuple[int, np.ndarray] | None = None
        self.algorithm = FusedMonoTracking() if config.tracking.fused_pipeline else MonoTracking()

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype).to(self.device)

    # -- state proxied to the SLAM facade ------------------------------------
    @property
    def state(self) -> State:
        return self._slam.state if self._slam is not None else self._state

    @state.setter
    def state(self, value: State) -> None:
        if self._slam is not None:
            self._slam.state = value
        else:
            self._state = value

    # -- entry point ---------------------------------------------------------
    def track(self, images, timestamp: float, depth=None) -> dict:
        state = self.state
        if state == State.NO_IMAGES_YET:
            if self.config.camera.sensor_type == "monocular":
                self._process_first_frame(images, timestamp, depth)
            else:
                # Stereo and RGB-D measure depth: initialize on the first frame.
                self._try_initialize(images, timestamp, depth)
            return {"state": self.state.name}
        if state in (State.NOT_INITIALIZED, State.INITIALIZING):
            self._try_initialize(images, timestamp, depth)
            return {"state": self.state.name}
        if state == State.OK:
            info = self._track_ok(images, timestamp, depth)
            info["state"] = self.state.name
            return info
        if state == State.LOST:
            info = self._relocalize(images, timestamp, depth)
            info["state"] = self.state.name
            return info
        return {"state": state.name}

    # -- bootstrap states ----------------------------------------------------
    def _process_first_frame(self, images, timestamp, depth) -> None:
        self.initializer.add_frame(images, timestamp, depth)
        self.state = State.NOT_INITIALIZED

    def _try_initialize(self, images, timestamp, depth) -> None:
        self.state = State.INITIALIZING
        if self.initializer.initialize(images, timestamp, depth):
            self.reference_keyframe = self.map.get_last_keyframe()
            self.current_frame = self.map.get_last_frame()
            self.last_frame = self.current_frame
            self.last_keyframe_frame_id = self.current_frame.id if self.current_frame else -1
            self.motion_model = np.eye(4)
            self.state = State.OK

    # -- steady state --------------------------------------------------------
    def _track_ok(self, images, timestamp, depth) -> dict:
        # Stereo and RGB-D share the mono core; their frames carry depths.
        return self._track_mono(images, timestamp, depth)

    def _track_mono(self, images, timestamp, depth) -> dict:
        kf_ref = self.map.get_last_keyframe()
        self.reference_keyframe = kf_ref
        frame, info = self.algorithm.process(self, images, timestamp, depth)
        match_res = info.pop("match_res", None)
        # A global BA may have renormalized the map gauge mid-frame: convert
        # the just-solved pose and the carried state before any decision.
        self._catch_up_gauge(frame)

        good = self._is_tracking_good(info)
        info["tracking_good"] = good
        if not good:
            self.logger.warning("tracking lost at frame %d (inliers=%s of %s)", frame.id, info.get("n_inliers"),
                                info.get("n_3d2d"))
            self.state = State.LOST
            self.last_track_info = info
            return info

        if self._need_new_keyframe(frame, kf_ref, info):
            self._create_keyframe(frame, match_res, info)
            info["new_keyframe"] = True

        self._update_tracking_state(frame)
        info.pop("guided", None)  # internal association payload
        info.pop("pnp_inliers", None)
        self.last_track_info = info
        return info

    def _create_frame(self, images, timestamp, depth) -> Frame:
        """Detect on every camera (kernel K1; a stereo pair as one batch),
        undistort the keypoints to ideal pinhole pixels once, here, and
        measure the keypoints' depths."""
        images, grays = frame_images(images, depth, self.config.camera.sensor_type)
        feats = detect_frame_features(self.tracker, self.camera, grays)
        frame = Frame(images=images, images_gray=grays, features=feats, timestamp=timestamp, depth=depth)
        self._measure_depth(frame)
        self.map.add_frame(frame)
        self.current_frame = frame
        return frame

    def _measure_depth(self, frame: Frame) -> None:
        """Per-keypoint depth of the second modality (``frame.kp_z`` and
        ``kp_z_valid``, host arrays slot-aligned with camera 0): the
        row-gated left/right match of a stereo pair, or the depth map's
        pixel under each keypoint; one fetch. It feeds the depth-aware pose
        solve and the keyframe handlers."""
        sensor = self.config.camera.sensor_type
        if not self.config.tracking.use_depth_residual:
            return
        feats = frame.get_features(0)
        if sensor == "stereo" and frame.get_features(1) is not None:
            bf = float(getattr(self.camera, "bf", 0.0))
            if bf <= 0:
                return
            second = frame.get_features(1)
        elif sensor == "rgbd" and frame.depth is not None:
            bf, second = 0.0, self._t(frame.depth)
        else:
            return
        frame.kp_z, frame.kp_z_valid = to_host(
            measure_keypoint_depths(feats, second, bf, **depth_settings(self.config)))

    def _depth_baseline(self) -> float:
        """Baseline (m) of the normalized-disparity residual: the rig's for
        stereo, ``tracking.rgbd_virtual_baseline`` for RGB-D."""
        if self.config.camera.sensor_type == "stereo":
            return float(getattr(self.camera, "baseline", 0.0))
        return float(self.config.tracking.rgbd_virtual_baseline)

    def _predict_pose(self, frame: Frame) -> None:
        """Constant-velocity prediction."""
        if self.last_frame is not None:
            frame.update_pose(self.motion_model @ self.last_frame.T_w2c)

    # -- mono-gauge catch-up (threaded mode) -----------------------------------
    def _consistent_gather(self, fn):
        """Run a landmark gather against one gauge snapshot: a global BA
        rescales every landmark and bumps the gauge version under the map
        lock, so an unchanged version proves the gather saw one gauge. A torn
        read is retried, then done under the map lock."""
        ref = self.reference_keyframe
        for _ in range(3):
            v0 = self.map.gauge_version
            out = fn()
            if self.map.gauge_version == v0:
                self._gather_gauge_version = v0
                if ref is not None:
                    self._gather_ref_snap = (ref.keyframe_id, ref.T_w2c.copy())
                return out
        with self.map._lock:
            self._gather_gauge_version = self.map.gauge_version
            if ref is not None:
                self._gather_ref_snap = (ref.keyframe_id, ref.T_w2c.copy())
            return fn()

    @staticmethod
    def _apply_similarity_to_pose(frame, s: float, b: np.ndarray) -> None:
        """Move a pose solved in an old gauge into the current one: the
        similarity x -> s*x + b moves the camera centre, the rotation stays."""
        R = frame.R_w2c
        C = s * frame.t_c2w + b
        frame.set_pose_Rt(R, -R @ C)

    def _catch_up_gauge(self, frame: Frame | None) -> None:
        """Bring the in-flight frame pose and the carried state (last frame,
        motion-model translation) up to the map's current gauge. A no-op in
        synchronous mode."""
        v_now = self.map.gauge_version
        if frame is not None and self._gather_gauge_version != v_now:
            s, b = self.map.gauge_since(self._gather_gauge_version)
            self._apply_similarity_to_pose(frame, s, b)
            # Keep the gather-time reference snapshot in the same gauge.
            if self._gather_ref_snap is not None:
                _, T_snap = self._gather_ref_snap
                R = T_snap[:3, :3]
                C = s * (-R.T @ T_snap[:3, 3]) + b
                T_snap = T_snap.copy()
                T_snap[:3, 3] = -R @ C
                self._gather_ref_snap = (self._gather_ref_snap[0], T_snap)
        if self._gauge_seen != v_now:
            s, b = self.map.gauge_since(self._gauge_seen)
            if self.last_frame is not None and self.last_frame is not frame:
                self._apply_similarity_to_pose(self.last_frame, s, b)
            self.motion_model = self.motion_model.copy()
            self.motion_model[:3, 3] *= s
        self._gauge_seen = v_now
        self._gather_gauge_version = v_now

    def _track_reference_keyframe(self, frame: Frame, kf_ref: KeyFrame):
        """Match the frame to ``kf_ref`` (kernel K2) and gather the 3D-2D
        pairs by keypoint slot. Returns (match, pts3d, xy_obs, pair_valid)."""
        if kf_ref is None:
            return None, None, None, np.zeros(0, bool)
        res = self.tracker.match(frame.get_features(0), kf_ref.get_features(0))
        ref_pos, ref_mask = self._consistent_gather(lambda: kf_ref.point_arrays(0))
        ti, valid = to_host((res.train_idx, res.valid))
        pair_valid = valid & ref_mask[ti]
        return res, ref_pos[ti], frame.keypoints(0), pair_valid

    def _local_landmark_block(self, n_keyframes: int = 3, cap: int | None = None, keyframes=None):
        """Dense local-map landmark block (positions, descriptors, mask,
        landmarks) of the last ``n_keyframes`` keyframes (or of
        ``keyframes``), padded to a fixed capacity that scales with the
        feature budget."""
        if cap is None:
            cap = max(2048, 2 * self.config.feature.num_features)

        def gather():
            mps = {}
            for kf in keyframes if keyframes is not None else self.map.get_keyframes()[-n_keyframes:]:
                for mp in list(kf.map_points.values()):
                    if not mp.is_bad and mp.descriptor is not None:
                        mps[mp.id] = mp
            pos = np.zeros((cap, 3), np.float32)
            desc = np.zeros((cap, self.tracker.desc_words), np.int32)
            valid = np.zeros(cap, bool)
            sel = list(mps.values())[:cap]
            if sel:
                pos[:len(sel)] = np.stack([mp.position for mp in sel])
                desc[:len(sel)] = np.stack([mp.descriptor for mp in sel])
                valid[:len(sel)] = True
            return pos, desc, valid, sel

        return self._consistent_gather(gather)

    def _track_guided(self, frame: Frame, n_keyframes: int = 3, radius_px: float = 25.0, keyframes=None):
        """Projection-guided local-map association (kernel K3): landmarks
        projected into the predicted pose, matched within a pixel window.
        Returns a keypoint-aligned dict (pts3d, xy, valid, lm_idx,
        landmarks), or None without landmarks."""
        from .ops.guided_matching import guided_match

        pos, desc, lvalid, landmarks = self._local_landmark_block(n_keyframes, keyframes=keyframes)
        if not lvalid.any():
            return None
        feats = frame.get_features(0)
        res = guided_match(
            self._t(pos), torch.from_numpy(desc).to(self.device), self._t(lvalid, torch.bool),
            self._t(frame.T_w2c), self._K, feats.xy, feats.desc, feats.valid,
            float(self.camera.width), float(self.camera.height), radius_px=radius_px,
        )
        pts3d, valid, lm_idx = to_host((res["pts3d"], res["valid"], res["lm_idx"]))
        return {"pts3d": pts3d, "xy": frame.keypoints(0), "valid": valid, "lm_idx": lm_idx, "landmarks": landmarks}

    def _track_local_map(self, frame: Frame, n_keyframes: int = 3):
        """3D-2D candidates against each of the last ``n_keyframes``
        keyframes (kernel K2 per keyframe); each keypoint keeps its lowest
        distance association. Returns (match of the newest keyframe, pts3d,
        xy_obs, pair_valid)."""
        kfs = self.map.get_keyframes()[-n_keyframes:]
        if not kfs:
            return None, None, None, np.zeros(0, bool)
        feats_cur = frame.get_features(0)
        Kslots = feats_cur.xy.shape[0]

        def gather():
            best_dist = np.full(Kslots, np.inf, np.float32)
            pts3d = np.zeros((Kslots, 3), np.float32)
            pair_valid = np.zeros(Kslots, bool)
            res_last = None
            for kf in reversed(kfs):  # newest first
                res = self.tracker.match(feats_cur, kf.get_features(0))
                if res_last is None:
                    res_last = res
                ref_pos, ref_mask = kf.point_arrays(0)
                ti, valid, dist = to_host((res.train_idx, res.valid, res.distance))
                ok = valid & ref_mask[ti]
                take = ok & (dist < best_dist)
                best_dist[take] = dist[take]
                pts3d[take] = ref_pos[ti[take]]
                pair_valid |= take
            return res_last, pts3d, pair_valid

        res_last, pts3d, pair_valid = self._consistent_gather(gather)
        return res_last, pts3d, frame.keypoints(0), pair_valid

    def _optimize_pose(self, frame: Frame, pts3d, xy_obs, pair_valid, sample_idx=None) -> dict:
        """RANSAC-PnP on the device, then, under ``min_inliers``, a robust GN
        from the predicted pose; one fetch of the result. A frame with
        per-keypoint depths (stereo, RGB-D) whose candidates are keypoint
        slots adds the depth residual to both solves. ``sample_idx``
        (pnp_hypotheses, 6) replaces the generator's draws (the tests feed
        the JAX sampler's)."""
        tcfg = self.config.tracking
        thresh = tcfg.pnp_threshold_px / self.camera.fx
        X = self._t(pts3d)
        mask = self._t(pair_valid, torch.bool)
        xy_norm = normalize_points(self._Kinv, self._t(xy_obs))
        depth_ransac, depth_gn = {}, {}  # the depth residual's arguments, as each solve takes them
        if frame.kp_z is not None and len(frame.kp_z) == len(xy_obs) and self._depth_baseline() > 0:
            z, z_ok, b = self._t(frame.kp_z), self._t(frame.kp_z_valid, torch.bool), self._depth_baseline()
            depth_ransac = {"z_meas": z, "z_valid": z_ok, "baseline": b}
            depth_gn = {"z_meas": z, "w_z": z_ok.to(torch.float32), "baseline": b}
        res = ransac_pnp(X, xy_norm, mask, self._gen, n_hyp=tcfg.pnp_hypotheses, thresh=thresh,
                         sample_idx=None if sample_idx is None else sample_idx.to(self.device), **depth_ransac)
        ok, n_inl, R, t, inliers = to_host((res["ok"], res["n_inliers"], res["R"], res["t"], res["inliers"]))
        ok, n_inl = bool(ok), int(n_inl)
        n_pairs = max(int(np.asarray(pair_valid).sum()), 1)
        if n_inl < tcfg.min_inliers:
            # Motion-model fallback: robust GN from the predicted pose.
            R1, t1 = refine_pose_gn(self._t(frame.R_w2c), self._t(frame.t_w2c), X, xy_norm, mask.to(torch.float32),
                                    iters=10, huber=thresh, **depth_gn)
            inl2 = (_reproj_err2(R1, t1, X, xy_norm) < thresh * thresh) & mask
            R1, t1, inl2 = to_host((R1, t1, inl2))
            if int(inl2.sum()) > n_inl:
                R, t, inliers = R1, t1, inl2
                n_inl = int(inl2.sum())
                ok = n_inl >= 6
        if ok:
            frame.set_pose_Rt(np.asarray(R, np.float64), np.asarray(t, np.float64))
        return {"ok": ok, "n_inliers": n_inl, "inlier_ratio": n_inl / n_pairs, "pnp_inliers": np.asarray(inliers)}

    def _is_tracking_good(self, info: dict) -> bool:
        tcfg = self.config.tracking
        if not info.get("ok", False):
            return False
        if info.get("n_inliers", 0) < tcfg.min_inliers:
            return False
        if info.get("inlier_ratio", 0.0) < tcfg.min_inlier_ratio:
            return False
        if tcfg.check_reprojection_error and self.current_frame is not None:
            if self.map.compute_mean_reprojection_error(self.camera.K) > tcfg.max_reprojection_error:
                return False
        return True

    def _need_new_keyframe(self, frame: Frame, kf_ref: KeyFrame, info: dict) -> bool:
        if kf_ref is None:
            return False
        tcfg = self.config.tracking
        gap = frame.id - self.last_keyframe_frame_id
        if gap <= 0:
            return False
        if info.get("n_inliers", 0) < tcfg.kf_min_matches:
            return True
        # Landmark coverage is thinning: refresh the local map first.
        if info.get("n_3d2d", 0) < 2 * tcfg.kf_min_matches:
            return True
        if gap > tcfg.keyframe_interval:
            return True
        trans = float(np.linalg.norm(frame.t_c2w - kf_ref.t_c2w))
        # f32 on the host, as the JAX package computes it.
        R_rel = torch.from_numpy((frame.R_w2c @ kf_ref.R_w2c.T).astype(np.float32))
        rot_deg = float(np.rad2deg(rotation_angle(R_rel).numpy()))
        return trans > tcfg.kf_min_translation or rot_deg > tcfg.kf_min_rotation_deg

    def _create_keyframe(self, frame: Frame, match_res, info: dict) -> None:
        """Promote the frame to a keyframe, inherit its tracked landmarks and
        hand it to local mapping."""
        # Re-anchor through the reference keyframe's pose delta: if a BA
        # writeback moved the map between this frame's gather and now,
        # T_rel = T_frame @ inv(T_ref_at_gather) is BA-invariant. A no-op in
        # synchronous mode.
        snap = self._gather_ref_snap
        ref = self.reference_keyframe
        if snap is not None and ref is not None and snap[0] == ref.keyframe_id:
            with self.map._lock:
                T_ref_now = ref.T_w2c.copy()
            if not np.allclose(T_ref_now, snap[1], atol=1e-12):
                T_new = frame.T_w2c @ np.linalg.inv(snap[1]) @ T_ref_now
                frame.set_pose_Rt(T_new[:3, :3], T_new[:3, 3])
        kf = KeyFrame.from_frame(frame)
        kf.gauge_version = self._gauge_seen  # re-checked by the mapping consumer
        pnp_inl = info.get("pnp_inliers")
        guided = info.get("guided")
        if guided is not None:
            # Guided path: keypoint slot -> landmark identity directly.
            ok = guided["valid"]
            if pnp_inl is not None:
                ok = ok & np.asarray(pnp_inl)
            landmarks = guided["landmarks"]
            lm_idx = guided["lm_idx"]
            for i_cur in np.nonzero(ok)[0]:
                mp = landmarks[int(lm_idx[i_cur])]
                if not mp.is_bad:
                    kf.add_map_point(0, int(i_cur), mp)
        elif match_res is not None and self.reference_keyframe is not None:
            ti, ok = to_host((match_res.train_idx, match_res.valid))
            if pnp_inl is not None:
                ok = ok & np.asarray(pnp_inl)
            for i_cur in np.nonzero(ok)[0]:
                mp = self.reference_keyframe.get_map_point(0, int(ti[i_cur]))
                if mp is not None and not mp.is_bad:
                    kf.add_map_point(0, int(i_cur), mp)
        self.last_keyframe_frame_id = frame.id
        self.local_mapping.insert_keyframe(kf)
        self.reference_keyframe = kf

    def _update_tracking_state(self, frame: Frame) -> None:
        """Motion model T_rel = T_cur @ inv(T_last)."""
        if self.last_frame is not None:
            self.motion_model = frame.T_w2c @ np.linalg.inv(self.last_frame.T_w2c)
        self.last_frame = frame

    # -- relocalization --------------------------------------------------------
    def _relocalize(self, images, timestamp, depth, max_candidates: int = 5) -> dict:
        """Stage 1: a coarse pose by PnP against each candidate keyframe (the
        recent ones, then the global-signature shortlist of the whole map),
        their union as a backstop. Stage 2: a projection-guided refine over
        the candidates' landmarks; success promotes the frame to a keyframe."""
        frame = self._create_frame(images, timestamp, depth)
        recent = list(reversed(self.map.get_keyframes()[-max_candidates:]))
        tried = {kf.keyframe_id for kf in recent}
        candidates = recent + self._reloc_global_candidates(frame, exclude=tried, top_n=max_candidates)
        blocks = []
        per_kf = []  # (n_pairs, kf, match_res)
        best = None  # (n_inliers, T_w2c, kf, match_res)
        for kf in candidates:
            res, pts3d, xy_obs, pair_valid = self._track_reference_keyframe(frame, kf)
            if res is None:
                continue
            n = int(pair_valid.sum())
            per_kf.append((n, kf, res))
            if n > 0:
                blocks.append((pts3d, xy_obs, pair_valid))
            if n >= 6:
                pr = self._optimize_pose(frame, pts3d, xy_obs, pair_valid)
                n_inl = pr.get("n_inliers", 0)
                if pr.get("ok") and n_inl >= 6 and (best is None or n_inl > best[0]):
                    best = (n_inl, frame.T_w2c.copy(), kf, res)
        if not blocks or not per_kf:
            return {"ok": False, "relocalized": False}
        if best is None:
            # Union backstop, padded to a fixed block count.
            n_blocks = 2 * max_candidates
            Kf = blocks[0][0].shape[0]
            blocks = blocks[:n_blocks]
            while len(blocks) < n_blocks:
                blocks.append((np.zeros((Kf, 3), np.float32), np.zeros((Kf, 2), np.float32), np.zeros(Kf, bool)))
            pose_res = self._optimize_pose(frame, np.concatenate([b[0] for b in blocks]),
                                           np.concatenate([b[1] for b in blocks]),
                                           np.concatenate([b[2] for b in blocks]))
            self.logger.debug("reloc union: %d pairs over %d candidates -> ok=%s inl=%d",
                              sum(int(b[2].sum()) for b in blocks), len(per_kf), pose_res.get("ok"),
                              pose_res.get("n_inliers", 0))
            if pose_res.get("ok") and pose_res.get("n_inliers", 0) >= 6:
                _, kf_best, res_best = max(per_kf, key=lambda t: t[0])
                best = (pose_res["n_inliers"], frame.T_w2c.copy(), kf_best, res_best)
        if best is None:
            return {"ok": False, "relocalized": False}
        # Re-impose the winning coarse pose (a later attempt may have
        # overwritten the frame pose with a worse accepted solve).
        _, T_best, best_kf, best_res = best
        frame.set_pose_Rt(T_best[:3, :3], T_best[:3, 3])
        pose_res = {"ok": True, "n_inliers": best[0], "inlier_ratio": 1.0}
        guided = self._track_guided(frame, radius_px=30.0, keyframes=[kf for _, kf, _ in per_kf])
        guided_used = None
        if guided is not None and int(guided["valid"].sum()) >= 6:
            refined = self._optimize_pose(frame, guided["pts3d"], guided["xy"], guided["valid"])
            if refined.get("ok"):
                pose_res = refined
                guided_used = guided
        self.logger.debug("reloc guided: %s assoc -> inl=%d ratio=%.2f",
                          "none" if guided is None else int(guided["valid"].sum()), pose_res.get("n_inliers", 0),
                          pose_res.get("inlier_ratio", 0.0))
        if guided_used is not None and self._is_tracking_good(pose_res):
            self.logger.info("relocalized against KF %d (union %d pairs over %d candidates)", best_kf.keyframe_id,
                             pose_res.get("n_inliers", 0), len(per_kf))
            self.reference_keyframe = best_kf
            # The relocalized frame becomes a keyframe, so the next frames
            # track fresh geometry rather than the stale pre-loss keyframes.
            self._create_keyframe(frame, best_res, {"pnp_inliers": pose_res.get("pnp_inliers"),
                                                    "guided": guided_used})
            self.motion_model = np.eye(4)
            self.last_frame = frame
            self.state = State.OK
            pose_res["relocalized"] = True
            return pose_res
        return {"ok": False, "relocalized": False}

    def _reloc_global_candidates(self, frame: Frame, exclude, top_n: int = 5):
        """The ``top_n`` keyframes of the whole map by global-signature
        similarity (loop_closing/signature.py): one batched pass for the
        keyframes without a signature yet, a host matvec to score."""
        from .loop_closing.signature import batch_signatures, keyframe_signature, score_signatures

        kfs = [kf for kf in self.map.get_keyframes() if kf.keyframe_id not in exclude and kf.get_features(0) is not None]
        if not kfs:
            return []
        if len(self._reloc_sig_table) > len(kfs) + 64:
            # Evict the signatures of culled keyframes.
            live = {kf.keyframe_id for kf in kfs}
            for kf_id in [k for k in self._reloc_sig_table if k not in live]:
                del self._reloc_sig_table[kf_id]
        missing = [kf for kf in kfs if kf.keyframe_id not in self._reloc_sig_table]
        if missing:
            descs = torch.stack([kf.get_features(0).desc for kf in missing])
            valids = torch.stack([kf.get_features(0).valid for kf in missing])
            for kf, sig in zip(missing, batch_signatures(descs, valids)):
                self._reloc_sig_table[kf.keyframe_id] = sig
        f = frame.get_features(0)
        if f is None:
            return []
        q = keyframe_signature(f.desc, f.valid).cpu().numpy()
        table = np.stack([self._reloc_sig_table[kf.keyframe_id] for kf in kfs])
        top = np.argsort(-score_signatures(q, table))[:top_n]
        return [kfs[int(i)] for i in top]


def _to_gray(img: np.ndarray) -> np.ndarray:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.float32)


def frame_images(images, depth, sensor: str):
    """(images, grayscale images) of one frame as lists; a stereo frame needs
    [left, right] and an RGB-D frame a depth map, or this raises."""
    images = list(images) if isinstance(images, (list, tuple)) else [images]
    if sensor == "stereo" and len(images) < 2:
        raise ValueError("a stereo frame needs [left, right] images")
    if sensor == "rgbd" and depth is None:
        raise ValueError("an RGB-D frame needs a depth image")
    return images, [im if im.ndim == 2 else _to_gray(im) for im in images]


def detect_frame_features(tracker, camera, grays) -> list[Features]:
    """Every camera's feature block, undistorted to ideal pinhole pixels.
    Cameras of one size (a stereo pair) go through the detector as one
    (B, H, W) batch: kernel K1, and every other op of the detector, launch
    once for the frame."""
    if len(grays) > 1 and all(np.shape(g) == np.shape(grays[0]) for g in grays):
        batch = tracker.detectAndCompute(np.stack([np.asarray(g, np.float32) for g in grays]))
        feats = [Features(*[a[b] for a in batch]) for b in range(len(grays))]
    else:
        feats = [tracker.detectAndCompute(g) for g in grays]
    return [undistort_features(f, camera) for f in feats]


def undistort_features(feats, camera):
    """Replace keypoint pixel coordinates with their ideal-pinhole positions
    (no-op for distortion-free cameras)."""
    if not camera.has_distortion:
        return feats
    dev = feats.xy.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    return feats._replace(xy=undistort_pixels(t(camera.K), t(camera.Kinv), t(camera.D), feats.xy))
