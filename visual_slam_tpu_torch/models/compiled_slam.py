"""CompiledSLAM: the full mono, stereo or RGB-D SLAM system around the fused
tracking step (port of ``visual_slam_tpu.models.compiled_slam``).

``CompiledSLAM(camera, config, device=...)`` then ``track(images,
timestamp)`` per frame, ``flush()`` at the end of a sequence and
``trajectory()`` for the per-frame poses. ``device`` defaults to the card
(``"cuda"``; without one the constructor raises): pass ``device="cpu"`` to
run on the CPU through the kernels' plain versions. The first frames bootstrap the
map (``Initializer``: two-view essential matrix + triangulation + BA);
after that every frame runs the fused step on the device (detect with
kernel K1, match with K2, guided arena match with K3, RANSAC-PnP), alone
or in chunks of ``tracking.chunk_size`` frames:

* per frame: the keyframe decision reads the previous frame's scalars;
* plain chunks: the reference stays fixed within a chunk and the host
  promotes the newest healthy frame at the boundary;
* self-promoting chunks (``tracking.device_promotion``): the device swaps
  its own reference on the keyframe gates inside the chunk
  (``pipeline.make_track_chunk_promote``); at the boundary one fetch of
  the compact structure (``pipeline.make_compact_chunk``) brings the
  decision scalars and the promoted frames' blocks, the host replays the
  promotions into map keyframes and landmarks, enforces the landmark
  budget, and every ``heavy_boundary_every``-th promotion runs the
  LM/Schur bundle adjustment (dense, or sparse landmark-major with
  ``optimization.sparse_obs``) and re-installs the corrected reference;
* async heavy boundaries (``tracking.async_boundary``, self-promoting
  chunks, once the map holds ``async_boundary_min_kfs`` keyframes and
  outside the ``async_boundary_cooloff`` boundaries after thin tracking):
  the solve started at one boundary runs on a side CUDA stream and lands
  at the next, whose device state is carried into the post-solve world by
  one similarity correction (``pipeline.apply_correction``) instead of a
  reference re-install.

With ``optimization.async_ba`` the keyframe-boundary solve of the per-frame
and plain-chunk paths likewise lands at the next boundary (triangulation
uses the pre-solve poses). A frame below ``min_inliers`` gets a brute
multi-keyframe recovery before it is declared LOST; a LOST system
relocalizes against recent keyframes. Keyframe features stay on the
device; their host views are filled from the fetch that brought them.

Stereo (``camera.sensor_type = "stereo"`` with ``tracking.use_depth_residual``
and a camera ``baseline`` > 0; otherwise the mono step runs, as in the JAX
package): ``track([left, right], t)``; the step takes the rectified pair,
the bootstrap is one pair's metric map, and new landmarks come from the
step's disparity depths: minted inside the self-promoting chunk
(``make_track_chunk_promote(stereo=True)``), and on a heavy host promotion
(per frame, plain chunks, relocalization) by ``_create_stereo_points``.

RGB-D (``camera.sensor_type = "rgbd"``): ``track([image], t, depth=metres)``;
as in the JAX package there is no RGB-D step: the bootstrap is one frame's
metric map from its depth map (``Initializer._initialize_rgbd``; a frame
without one leaves the system ``INITIALIZING``), after which the mono step,
the mono chunks and mono promotion with triangulation run, and
relocalization ignores depth.

``optimization.lm_minor=True`` is accepted and solves on the dense grid
(``backend.optimizer``).

Not ported, raising ``NotImplementedError`` when its switch is on: ragged
descriptors.

``save(path)`` checkpoints the map, the trajectory and the config in the
JAX package's format; ``CompiledSLAM.resume(path, camera, device=...)``
goes on from a checkpoint of either package.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..backend.optimizer import LMOptimizer
from ..camera import PinholeCamera
from ..config import Config
from ..frontend.tracker import FeatureTracker
from ..initializer import Initializer
from ..map import Frame, KeyFrame, Map, MapPoint
from ..ops.detector import Features
from ..ops.matching import match_descriptors
from ..ops.pnp import ransac_pnp
from ..ops.projection import normalize_points
from ..ops.stereo import backproject_np
from ..ops.triangulation import triangulate_gated
from ..pipeline import (
    PromoteRecord,
    TrackOutput,
    apply_correction,
    correction_similarity,
    init_track_state,
    make_compact_chunk,
    make_track_chunk,
    make_track_chunk_promote,
    make_track_step,
    set_local_map,
    swap_reference,
)
from ..state import State
from ..utils.device import default_device
from ..utils.logging import get_logger
from ..utils.tree import as_numpy as _np
from ..utils.tree import to_device, to_host, tree_map


def _motion_from(T: np.ndarray, ref_kf: KeyFrame) -> tuple[float, float]:
    """Rotation (degrees) and camera-center distance of pose T from ``ref_kf``."""
    R_rel = T[:3, :3] @ ref_kf.R_w2c.T
    c = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
    C = -T[:3, :3].T @ T[:3, 3]
    return float(np.degrees(np.arccos(c))), float(np.linalg.norm(C - ref_kf.camera_center))


class CompiledSLAM:
    def __init__(self, camera: PinholeCamera, config: Config | None = None, log_dir: str | None = None,
                 device=None):
        self.camera = camera
        self.config = config or Config()
        self.device = default_device(device)
        self.logger = get_logger("compiled_slam", log_dir)
        fcfg = self.config.feature
        tcfg = self.config.tracking
        ocfg = self.config.optimization
        sensor = self.config.camera.sensor_type
        if fcfg.ragged_descriptors:
            raise NotImplementedError("ragged descriptors are not ported yet")
        self._chunk_size = max(1, int(tcfg.chunk_size))
        self._dev_promo = bool(tcfg.device_promotion) and self._chunk_size > 1
        self._async_ba = bool(ocfg.async_ba)
        self.map = Map(max_frames=self.config.map.max_frames)
        self.optimizer = LMOptimizer(self.config, camera, logger=self.logger, device=self.device)
        self.state = State.NO_IMAGES_YET
        self._arena_size = int(tcfg.local_map_size)
        # A rectified stereo rig: the step takes (2, H, W) pairs, measures
        # each keypoint's depth and solves the depth-aware PnP.
        baseline = float(getattr(camera, "baseline", 0.0))
        self._stereo = sensor == "stereo" and tcfg.use_depth_residual and baseline > 0
        self._step = make_track_step(
            camera.K,
            num_features=fcfg.num_features,
            fast_threshold=fcfg.fast_threshold,
            n_levels=fcfg.num_pyramid_levels,
            scale=fcfg.scale_factor,
            grid=fcfg.grid_cells,
            ratio=tcfg.match_ratio,
            pnp_hypotheses=tcfg.pnp_hypotheses,
            pnp_threshold_px=tcfg.pnp_threshold_px,
            local_map=self._arena_size > 0,
            width=camera.width,
            height=camera.height,
            guided_radius_px=tcfg.guided_radius_px,
            guided_ratio=tcfg.guided_ratio,
            stereo=self._stereo,
            baseline=baseline,
            stereo_row_tolerance=tcfg.stereo_row_tolerance,
            min_depth=self.config.local_mapping.min_depth,
            device=self.device,
        )
        self._track_state = None
        self._frames_since_kf = 0
        # Pose blocks: (timestamps, T_w2c device tensor ((4, 4) or (n, 4, 4)),
        # reference keyframe, its pose when the block was tracked).
        self.poses: list[tuple[tuple, object, object, object]] = []
        lcfg = self.config.local_mapping
        if self._chunk_size <= 1:
            self._chunk = None
        elif self._dev_promo:
            self._chunk = make_track_chunk_promote(
                self._step, camera.K,
                min_inliers=tcfg.min_inliers,
                keyframe_interval=tcfg.keyframe_interval,
                kf_min_matches=tcfg.kf_min_matches,
                kf_min_rotation_deg=tcfg.kf_min_rotation_deg,
                kf_min_translation=tcfg.kf_min_translation,
                min_depth=lcfg.min_depth,
                max_depth=lcfg.max_depth,
                min_parallax_deg=lcfg.min_parallax_deg,
                pnp_threshold_px=tcfg.pnp_threshold_px,
                stereo=self._stereo,
            )
        else:
            self._chunk = make_track_chunk(self._step)
        self._compact_P = int(tcfg.compact_fetch_promos)
        self._compact_fn = (make_compact_chunk(self._compact_P, with_sig=bool(self.config.loop_closing.enabled))
                            if self._dev_promo and self._compact_P > 0 else None)
        self._chunk_buf: list[tuple[object, float]] = []  # (host image, timestamp)
        self._promos_since_heavy = 0
        # Async heavy boundaries: the solve in flight ({"pending", "anchor",
        # "T_pre"}), the sync boundaries left after thin tracking, and the
        # device-chained frames-since-reference and reference pose.
        self._async_mode = bool(tcfg.async_boundary) and self._dev_promo
        self._async_bnd: Optional[dict] = None
        self._async_cooloff = 0
        self._prev_chunk_async = False
        self._dev_fsr = self._dev_T_ref = None
        # Previous frame's step output, deferred for the host decision:
        # (out, timestamp, ref_kf, arena) as they were when it was tracked.
        self._pending = None
        self._lm_arena: list[Optional[MapPoint]] = []
        self._ba_pending = None  # optimization.async_ba: the solve in flight
        self._ref_kf: KeyFrame | None = None
        self._feature_tracker = FeatureTracker(fcfg, device=self.device)
        self._initializer = Initializer(camera, self.config, self._feature_tracker, self.map, logger=self.logger)
        self._initializer.optimizer = self.optimizer
        self._Kinv = torch.as_tensor(np.asarray(camera.Kinv, np.float32)).to(self.device)
        self.loop_closing = None
        if self.config.loop_closing.enabled:
            from ..loop_closing import LoopClosing

            self.loop_closing = LoopClosing(self.map, camera, self.config, optimizer=self.optimizer,
                                            logger=self.logger)

    # ------------------------------------------------------------------ API
    def track(self, images, timestamp: float, depth=None) -> dict:
        imgs = list(images) if isinstance(images, (list, tuple)) else [images]
        if self.state == State.LOST:
            return self._relocalize(imgs, timestamp)
        if self.state != State.OK:
            return self._bootstrap(imgs, timestamp, depth)
        if self._chunk is not None:
            return self._track_chunked(imgs, timestamp)
        return self._track_compiled(imgs, timestamp)

    def _camera_images(self, imgs) -> list:
        """The images the step takes: [left, right] on a stereo system, else
        the first."""
        if not self._stereo:
            return imgs[:1]
        if len(imgs) < 2:
            raise ValueError("stereo-configured CompiledSLAM needs [left, right] images")
        return imgs[:2]

    def _img_arg(self, imgs) -> torch.Tensor:
        """One frame (H, W), or a stereo pair (2, H, W), on the device. The
        dtype is kept (uint8 uploads 4x less than f32; the detector casts on
        the device)."""
        ims = [im.to(self.device) if isinstance(im, torch.Tensor) else to_device(np.asarray(im), self.device)
               for im in self._camera_images(imgs)]
        return torch.stack(ims) if self._stereo else ims[0]

    def flush(self) -> dict:
        """Run the buffered partial chunk and the deferred decision of the
        last frame (call at the end of a sequence)."""
        info = {}
        if self._chunk_buf:
            info = self._run_chunk()
        if self._pending is not None:
            pending, self._pending = self._pending, None
            info = self._decide(*pending)
        self._finish_async_solve(correct_device=True)
        return info

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-frame poses (timestamps (N,), T_w2c (N, 4, 4)) in one
        device->host copy. Each frame is anchored to the keyframe it was
        tracked against, or to the keyframe made from it: T_rel (at track
        time) @ T_ref (now), so later BA and loop-closure corrections of the
        keyframe reach its frames, and a keyframe's frame has its pose.
        Blocks restored by ``resume`` keep their saved poses."""
        self._apply_pending_ba()
        if not self.poses:
            return np.zeros(0), np.zeros((0, 4, 4))
        ts = np.asarray([t for blk in self.poses for t in blk[0]])
        parts = [T if T.ndim == 3 else T[None] for (_, T, _, _) in self.poses]
        Ts = np.asarray(to_host(torch.cat(parts, dim=0)), np.float64)
        out = np.empty_like(Ts)
        i = 0
        for (ts_blk, _, ref_kf, T_ref_snap) in self.poses:
            n = len(ts_blk)
            if ref_kf is None:
                out[i:i + n] = Ts[i:i + n]
            else:
                out[i:i + n] = Ts[i:i + n] @ np.linalg.inv(T_ref_snap)[None] @ ref_kf.T_w2c[None]
            i += n
        return ts, out

    def shutdown(self) -> None:
        self.flush()
        self._apply_pending_ba()
        self.logger.info("shutdown: %d keyframes, %d landmarks, %d frame poses",
                         self.map.num_keyframes(), self.map.num_map_points(), self.num_frames_tracked())

    def num_frames_tracked(self) -> int:
        return sum(len(blk[0]) for blk in self.poses)

    def metrics(self) -> dict:
        return {
            "state": self.state.name,
            "num_keyframes": self.map.num_keyframes(),
            "num_map_points": self.map.num_map_points(),
            "num_frames": self.num_frames_tracked(),
        }

    def save(self, path) -> None:
        """Checkpoint into directory ``path``: the map (``map.npz``), the
        per-frame trajectory (``trajectory.npz``) and the state and config
        (``slam.json``), in the JAX package's format."""
        from pathlib import Path

        from ..utils.serialization import save_map

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        save_map(self.map, path / "map.npz")
        ts, Ts = self.trajectory()
        np.savez_compressed(path / "trajectory.npz", ts=ts, T_w2c=Ts)
        meta = {"state": self.state.name, "config": self.config.to_dict()}
        (path / "slam.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def resume(cls, path, camera, log_dir: str | None = None, device=None) -> "CompiledSLAM":
        """A system restored from a checkpoint of either package on
        ``device`` (the card unless named): the map is reloaded there, loop
        closing points at it, the reference block and landmark arena are
        installed from the last keyframe, and tracking goes on from the last
        saved frame's pose and frame-to-frame motion (``flush()`` before
        ``save`` so that no frame is left in a chunk buffer). The restored
        trajectory blocks carry no reference keyframe: they keep their saved
        poses."""
        from pathlib import Path

        from ..utils.serialization import load_map

        path = Path(path)
        meta = json.loads((path / "slam.json").read_text())
        slam = cls(camera, Config.from_dict(meta["config"]), log_dir=log_dir, device=device)
        slam.map = slam._initializer.map = load_map(path / "map.npz", device=slam.device)
        if slam.loop_closing is not None:
            slam.loop_closing.map = slam.map
        kf = slam.map.get_last_keyframe()
        ts = np.zeros(0)
        traj = path / "trajectory.npz"
        if traj.exists():  # the facade's checkpoints have none
            with np.load(traj) as z:
                ts, Ts = z["ts"], np.asarray(z["T_w2c"], np.float64)
            slam.poses += [((float(t),), T, None, None) for t, T in zip(ts, slam._dev_pose(Ts))]  # one upload
        if kf is not None and meta["state"] in ("OK", "MAPPING"):
            slam.state = State.OK
            slam._initializer.initialized = True
            slam._install_reference(kf, T_init=kf.T_w2c)
            if len(ts) and ts[-1] >= kf.timestamp:
                # Go on from the last tracked frame with its frame-to-frame
                # motion, as the saved system would have: from the keyframe's
                # pose without motion the guided match searches the wrong
                # place, and a first frame a few frames past the keyframe
                # loses track.
                T_rel = Ts[-1] @ np.linalg.inv(Ts[-2]) if len(ts) > 1 else np.eye(4)
                slam._track_state = slam._track_state._replace(T_w2c=slam._dev_pose(Ts[-1]),
                                                               T_rel=slam._dev_pose(T_rel))
                slam._frames_since_kf = int((ts > kf.timestamp).sum())
        return slam

    # ----------------------------------------------------------- bootstrap
    def _bootstrap(self, imgs, timestamp, depth) -> dict:
        self.state = State.INITIALIZING
        if depth is None and self.config.camera.sensor_type == "rgbd":
            # The one-frame RGB-D bootstrap needs the depth map: without one
            # the JAX package's fails and the system stays INITIALIZING (the
            # port's Initializer refuses such a frame, as the facade does).
            return {"state": self.state.name}
        if self._initializer.initialize(imgs, timestamp, depth):
            self.state = State.OK
            kf = self.map.get_last_keyframe()
            if self._stereo:
                self._describe_bootstrap(kf)
            self._install_reference(kf, T_init=kf.T_w2c)
            self.poses.append(((timestamp,), self._dev_pose(kf.T_w2c), kf, kf.T_w2c.copy()))
        return {"state": self.state.name}

    @staticmethod
    def _describe_bootstrap(kf: KeyFrame) -> None:
        """Give each landmark of the one-pair bootstrap the descriptor of the
        keypoint it was made from, as the two-view bootstrap does. The
        one-pair bootstrap leaves them without one (in the JAX package
        too), so the landmark arena stays empty until the first adopted
        keyframe and the first chunk tracks against the bootstrap block
        alone, with so few PnP inliers left by its fourth pair at KITTI
        width that float rounding decides where the first keyframe lands
        (ROADMAP F6, a departure from the JAX package)."""
        desc = kf.descriptors(0)
        for (cam, i), mp in kf.map_points.items():
            if cam == 0 and mp.descriptor is None:
                mp.descriptor = desc[i].copy()

    def _relocalize(self, imgs, timestamp) -> dict:
        """LOST recovery: the step against each recent keyframe's reference
        block (the step is a PnP relocalization given a candidate); on
        failure the pre-attempt reference is restored."""
        tcfg = self.config.tracking
        orig_ref, orig_state = self._ref_kf, self._track_state
        for kf in reversed(self.map.get_keyframes()[-5:]):
            self._install_reference(kf, T_init=kf.T_w2c)
            self._track_state, out = self._step(self._track_state, self._img_arg(imgs))
            n_inl, T = to_host((out.n_inliers, out.T_w2c))
            n_inl = int(n_inl)
            if n_inl >= tcfg.min_inliers:
                self.state = State.OK
                self.poses.append(((timestamp,), out.T_w2c, kf, kf.T_w2c.copy()))
                self._pending = None
                # The relocalized frame becomes a keyframe, so the frames
                # after it track fresh geometry.
                self._promote_keyframe(out, timestamp, kf, self._lm_arena)
                self.logger.info("relocalized against KF %d (%d inliers)", kf.keyframe_id, n_inl)
                return {"state": self.state.name, "relocalized": True, "n_inliers": n_inl,
                        "T_w2c": np.asarray(T, np.float64)}
        if orig_ref is not None:
            self._track_state = orig_state
            self._ref_kf = orig_ref
        return {"state": self.state.name, "relocalized": False}

    def _anchor_frame(self, timestamp: float, kf: KeyFrame, T_snap: np.ndarray) -> None:
        """Anchor the recorded pose of the frame at ``timestamp`` to ``kf``,
        which was made from it: ``T_snap`` is the pose recorded for the frame,
        so ``trajectory()`` gives the keyframe's pose there, now and after
        later corrections."""
        for b in range(len(self.poses) - 1, -1, -1):
            ts, T, ref, snap = self.poses[b]
            if timestamp in ts:
                j = ts.index(timestamp)
                T = T if T.ndim == 3 else T[None]
                parts = [(ts[:j], T[:j], ref, snap), ((timestamp,), T[j], kf, np.asarray(T_snap, np.float64)),
                         (ts[j + 1:], T[j + 1:], ref, snap)]
                self.poses[b:b + 1] = [p for p in parts if p[0]]
                return

    def _dev_pose(self, T) -> torch.Tensor:
        return to_device(np.asarray(T, np.float32), self.device)

    def _install_reference(self, kf: KeyFrame, T_init: np.ndarray) -> None:
        # A solve in flight targeted the state this install rebuilds from the
        # host: land its writeback first; its device correction is moot.
        self._finish_async_solve(correct_device=False)
        pos, mask = kf.point_arrays(0)
        feats = to_device(kf.get_features(0), self.device)
        if self._track_state is None:
            self._track_state = init_track_state(feats, pos, mask, T_init, local_map_size=self._arena_size,
                                                 device=self.device)
        else:
            pos, mask, T0 = to_device((pos, mask, np.asarray(T_init, np.float32)), self.device)
            self._track_state = swap_reference(self._track_state, feats, pos, mask)._replace(T_w2c=T0)
        self._ref_kf = kf
        if self._async_mode:  # the device-chained promotion counters restart at this reference
            self._dev_fsr = torch.zeros((), dtype=torch.int32, device=self.device)
            self._dev_T_ref = self._dev_pose(T_init)
        if self._arena_size:
            self._refresh_arena()

    def _refresh_arena(self) -> None:
        """Fill the device landmark arena with the local map: landmarks
        observed by the most recent keyframes, best-observed first."""
        M = self._arena_size
        seen: dict[int, MapPoint] = {}
        for kf in reversed(self.map.get_keyframes()[-8:]):
            for mp in list(kf.map_points.values()):
                if not mp.is_bad and mp.id not in seen:
                    seen[mp.id] = mp
            if len(seen) >= M:
                break
        arena = sorted(seen.values(), key=lambda mp: -mp.num_observations())[:M]
        pos = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.int32)
        valid = np.zeros((M,), bool)
        for r, mp in enumerate(arena):
            pos[r] = mp.position
            if mp.descriptor is not None:
                desc[r] = np.asarray(mp.descriptor).reshape(-1)[:8].view(np.int32)
                valid[r] = True
        self._lm_arena = arena
        self._track_state = set_local_map(self._track_state, *to_device((pos, desc, valid), self.device))

    # ------------------------------------------------------- steady state
    def _track_compiled(self, imgs, timestamp) -> dict:
        self._track_state, out = self._step(self._track_state, self._img_arg(imgs))
        self.poses.append(((timestamp,), out.T_w2c, self._ref_kf, self._ref_kf.T_w2c.copy()))
        self._frames_since_kf += 1
        info = {"state": self.state.name}
        # Decide on the PREVIOUS frame, whose scalars the device has long
        # finished by now.
        pending, self._pending = self._pending, (out, timestamp, self._ref_kf, self._lm_arena)
        if pending is not None:
            info.update(self._decide(*pending))
        return info

    def _img_buf(self, imgs):
        """Per-frame chunk-buffer entry, kept on the host so the chunk
        uploads as one stacked copy (a stereo pair as one (2, H, W) entry);
        float frames as f16 with ``tracking.upload_f16`` (the detector casts
        to f32 on the device)."""
        ims = [self._upload_cast(im) for im in self._camera_images(imgs)]
        if not self._stereo:
            return ims[0]
        if any(isinstance(im, torch.Tensor) for im in ims):
            return torch.stack([torch.as_tensor(im).to(self.device) for im in ims])
        return np.stack(ims)

    def _upload_cast(self, im):
        if (self.config.tracking.upload_f16 and isinstance(im, np.ndarray)
                and im.dtype in (np.float32, np.float64)):
            return im.astype(np.float16)
        return im

    def _stack_imgs(self, imgs) -> torch.Tensor:
        """The chunk's entries as one contiguous (C, H, W) or (C, 2, H, W)
        tensor on the device (the kernels take dense rows)."""
        if any(isinstance(im, torch.Tensor) for im in imgs):
            return torch.stack([torch.as_tensor(im).to(self.device) for im in imgs])
        return to_device(np.stack(imgs), self.device)

    def _track_chunked(self, imgs, timestamp: float) -> dict:
        """Buffer frames; every chunk_size-th frame runs the whole chunk."""
        self._chunk_buf.append((self._img_buf(imgs), timestamp))
        if len(self._chunk_buf) < self._chunk_size:
            return {"state": self.state.name, "buffered": len(self._chunk_buf)}
        return self._run_chunk()

    def _run_chunk(self) -> dict:
        buf, self._chunk_buf = self._chunk_buf, []
        n = len(buf)
        imgs = [im for im, _ in buf]
        while len(imgs) < self._chunk_size:  # flush pads; padded outputs are ignored
            imgs.append(imgs[-1])
        if self._dev_promo:
            if self._use_async_boundary():
                if not self._prev_chunk_async:
                    # sync -> async: the sync boundaries seed fsr and T_ref
                    # from the host and drop the device's chain; start the
                    # chain again from the host's values.
                    self._dev_fsr = torch.full((), self._frames_since_kf, dtype=torch.int32, device=self.device)
                    self._dev_T_ref = self._dev_pose(self._ref_kf.T_w2c)
                self._prev_chunk_async = True
                return self._run_chunk_devpromo_async(imgs, buf, n)
            self._prev_chunk_async = False
            # async -> sync: land the solve in flight (writeback and device
            # correction) before this chunk runs, so it runs in the
            # post-solve world.
            self._finish_async_solve(correct_device=True)
            return self._run_chunk_devpromo(imgs, buf, n)
        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        self._track_state, outs = self._chunk(self._track_state, self._stack_imgs(imgs))
        ts_tuple = tuple(t for _, t in buf)
        self.poses.append((ts_tuple, outs.T_w2c[:n], ref_kf, T_ref_snap))
        self._frames_since_kf += n
        # One fetch of the whole stacked output per chunk.
        outs_h = to_host(outs)
        n_inl_all = np.asarray(outs_h.n_inliers)[:n]
        T_all = np.asarray(outs_h.T_w2c)
        self.logger.debug("chunk: inliers %s matches %s guided %s", n_inl_all.tolist(),
                          np.asarray(outs_h.n_matches)[:n].tolist(),
                          np.asarray(outs_h.guided_valid)[:n].sum(axis=-1).tolist())
        tcfg = self.config.tracking
        last = n - 1
        info = {"state": self.state.name, "n_inliers": int(n_inl_all[last]), "chunk_frames": n}
        # The keyframe trigger comes before the lost check: promotion picks
        # the LATEST healthy frame of the chunk, so a mid-chunk inlier cliff
        # is answered with a fresh reference instead of LOST.
        healthy = n_inl_all >= tcfg.min_inliers
        rot_deg, trans = _motion_from(np.asarray(T_all[last], np.float64), ref_kf)
        trigger = (
            self._frames_since_kf > tcfg.keyframe_interval
            or int(n_inl_all.min()) < tcfg.kf_min_matches
            or rot_deg > tcfg.kf_min_rotation_deg
            or trans > tcfg.kf_min_translation
        )
        if trigger and healthy.any():
            j_star = int(np.nonzero(healthy)[0][-1])
            heavy = (
                tcfg.heavy_boundary_every <= 1
                or self._promos_since_heavy + 1 >= tcfg.heavy_boundary_every
                or int(n_inl_all[last]) < tcfg.kf_min_matches
            )
            self._promote_keyframe(tree_map(lambda a: a[j_star], outs), ts_tuple[j_star], ref_kf, arena,
                                   heavy=heavy, host=tree_map(lambda a: a[j_star], outs_h))
            self._promos_since_heavy = 0 if heavy else self._promos_since_heavy + 1
            # Frames after j_star stay tracked against the old reference.
            self._frames_since_kf = last - j_star
            if j_star != last:
                # Keep the newest frame's pose, carried through the new
                # keyframe's correction (the install reset it to the
                # keyframe's, which would rewind last - j_star frames).
                kf_new = self.map.get_last_keyframe()
                T_state = (np.asarray(T_all[last], np.float64) @ np.linalg.inv(np.asarray(T_all[j_star], np.float64))
                           @ kf_new.T_w2c)
                self._track_state = self._track_state._replace(T_w2c=self._dev_pose(T_state))
            info["new_keyframe"] = True
            return info
        if not healthy[last]:
            rec = self._brute_recover(tree_map(lambda a: a[last], outs), ts_tuple[-1])
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            info["state"] = self.state.name
            self.logger.warning("compiled tracking lost (chunk, %d inliers)", int(n_inl_all[last]))
        return info

    def _use_async_boundary(self) -> bool:
        """Async boundaries only on a mature map (``async_boundary_min_kfs``
        keyframes) and outside the cooloff after thin tracking
        (``async_boundary_cooloff`` boundaries)."""
        if not self._async_mode:
            return False
        tcfg = self.config.tracking
        if self.map.num_keyframes() < tcfg.async_boundary_min_kfs:
            return False
        if self._async_cooloff > 0:
            self._async_cooloff -= 1
            return False
        return True

    def _fetch_chunk(self, outs, recs, n: int):
        """One fetch per chunk: the compact structure (decision scalars and
        the promoted frames' blocks), or the whole output on slot overflow.
        Returns (comp, comp_dev, outs_h, recs_h, inliers (n,), promoted (n,),
        T_w2c (C, 4, 4)); comp is None after a whole fetch."""
        comp = comp_dev = outs_h = recs_h = None
        if self._compact_fn is not None:
            comp_dev = self._compact_fn(outs, recs)
            comp = to_host(comp_dev)
            if int(comp.n_promoted) > self._compact_P:
                self.logger.debug("compact fetch overflow (%d promos > %d slots): full fetch",
                                  int(comp.n_promoted), self._compact_P)
                comp = comp_dev = None
        if comp is None:
            outs_h, recs_h = to_host((outs, recs))
            return None, None, outs_h, recs_h, np.asarray(outs_h.n_inliers)[:n], np.asarray(recs_h.promoted)[:n], \
                np.asarray(outs_h.T_w2c)
        return comp, comp_dev, None, None, np.asarray(comp.n_inliers)[:n], np.asarray(comp.promoted)[:n], \
            np.asarray(comp.T_w2c)

    def _adopt_chunk(self, fetched, outs, ts_tuple, ref_kf, arena, U=None) -> list[KeyFrame]:
        """Replay the chunk's promotions into map keyframes, in order; with
        a correction ``U`` = (R_u, t_u, s) each promoted pose and its
        landmarks are carried into the corrected world first."""
        comp, comp_dev, outs_h, recs_h, n_inl_all, promoted, T_all_np = fetched
        cur_ref, new_kfs = ref_kf, []
        for s, f in enumerate(np.nonzero(promoted)[0]):
            if comp is not None:
                # Slot s of the compact structure is the s-th promoted frame.
                out_f = TrackOutput(
                    T_w2c=T_all_np[f], n_inliers=n_inl_all[f], n_matches=np.asarray(comp.n_matches)[f],
                    features=Features(*[a[s].clone() for a in comp_dev.feats]),
                    match_train_idx=comp.match_train_idx[s], match_valid=comp.match_valid[s],
                    pnp_inliers=comp.pnp_inliers[s], guided_idx=comp.guided_idx[s],
                    guided_valid=comp.guided_valid[s], kp_z=None, kp_z_valid=None,
                )
                host_feats = Features(*[a[s] for a in comp.feats])
                rec_f = PromoteRecord(promoted=True, ref_pos=comp.ref_pos[s], ref_has=comp.ref_has[s],
                                      ref_tri=comp.ref_tri[s])
            else:
                out_f = tree_map(lambda a: a[f], outs_h)._replace(
                    features=Features(*[a[f].clone() for a in outs.features]))
                host_feats = tree_map(lambda a: a[f], outs_h.features)
                rec_f = tree_map(lambda a: a[f], recs_h)
            if U is not None:
                R_u, t_u, sc = U
                T = np.asarray(out_f.T_w2c, np.float64).copy()
                T[:3, :3] = T[:3, :3] @ R_u.T
                T[:3, 3] = sc * T[:3, 3] - T[:3, :3] @ t_u
                out_f = out_f._replace(T_w2c=T)
                rec_f = rec_f._replace(ref_pos=sc * np.asarray(_np(rec_f.ref_pos), np.float64) @ R_u.T + t_u)
            kf = self._adopt_device_keyframe(out_f, rec_f, ts_tuple[f], cur_ref, arena, host_feats=host_feats)
            if comp is not None and self.loop_closing is not None:
                # The signature came with the same fetch.
                self.loop_closing.note_signature(kf.keyframe_id, np.asarray(comp.sig)[s])
            new_kfs.append(kf)
            cur_ref = kf
        return new_kfs

    def _anchor_chunk(self, ts_tuple, promo_idx, new_kfs, snaps) -> None:
        """From each promotion on, the chunk's frames follow the keyframe
        they were tracked against: the last pose block (the chunk's) is
        split at the promoted frames, each part anchored to its keyframe at
        ``snaps`` (the keyframe's pose in the world the chunk tracked in)."""
        n = len(ts_tuple)
        _, T_blk, ref_kf, T_ref_snap = self.poses.pop()
        cuts = [0, *[int(f) for f in promo_idx], n]
        anchors = [(ref_kf, T_ref_snap)] + list(zip(new_kfs, snaps))
        self.poses += [(ts_tuple[a:b], T_blk[a:b], kf, snap)
                       for a, b, (kf, snap) in zip(cuts[:-1], cuts[1:], anchors) if b > a]

    def _chunk_tail(self, info, n_inl_all, outs, ts_tuple, what: str) -> dict:
        """A chunk whose newest frame tracked under ``min_inliers``: brute
        recovery, else LOST."""
        last = len(ts_tuple) - 1
        if n_inl_all[last] < self.config.tracking.min_inliers:
            rec = self._brute_recover(tree_map(lambda a: a[last], outs), ts_tuple[-1])
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            info["state"] = self.state.name
            self.logger.warning("compiled tracking lost (%s chunk, %d inliers)", what, int(n_inl_all[last]))
        return info

    def _run_chunk_devpromo(self, imgs, buf, n: int) -> dict:
        """Boundary of the self-promoting chunk: the device already swapped
        its reference at every triggered frame; the host replays the
        promotions into map keyframes and landmarks from one fetch, runs BA
        on the heavy cadence and re-installs the corrected state only then."""
        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        self._track_state, _fsr, _T_ref, outs, recs = self._chunk(
            self._track_state, self._frames_since_kf, ref_kf.T_w2c, self._stack_imgs(imgs), n_valid=n,
        )
        ts_tuple = tuple(t for _, t in buf)
        self.poses.append((ts_tuple, outs.T_w2c[:n], ref_kf, T_ref_snap))
        fetched = self._fetch_chunk(outs, recs, n)
        n_inl_all, promoted, T_all_np = fetched[4:]
        tcfg = self.config.tracking
        last = n - 1
        info = {"state": self.state.name, "n_inliers": int(n_inl_all[last]), "chunk_frames": n}
        self.logger.debug("chunk(devpromo): inliers %s promoted %s", n_inl_all.tolist(),
                          np.nonzero(promoted)[0].tolist())
        promo_idx = np.nonzero(promoted)[0]
        new_kfs = self._adopt_chunk(fetched, outs, ts_tuple, ref_kf, arena)
        if new_kfs:
            self._anchor_chunk(ts_tuple, promo_idx, new_kfs, [kf.T_w2c.copy() for kf in new_kfs])
            kf_last = new_kfs[-1]
            self._frames_since_kf = last - int(promo_idx[-1])
            self._enforce_budget()
            heavy = (tcfg.heavy_boundary_every <= 1
                     or self._promos_since_heavy + len(new_kfs) >= tcfg.heavy_boundary_every)
            if heavy:
                self._promos_since_heavy = 0
                self._boundary_heavy(kf_last)
                # BA moved poses and landmarks: re-install the corrected
                # reference and a fresh arena, carrying the newest frame's
                # pose through the keyframe's correction.
                self._install_reference(kf_last, T_init=kf_last.T_w2c)
                T_state = (np.asarray(T_all_np[last], np.float64)
                           @ np.linalg.inv(np.asarray(T_all_np[promo_idx[-1]], np.float64)) @ kf_last.T_w2c)
                self._track_state = self._track_state._replace(T_w2c=self._dev_pose(T_state))
            else:
                # Light boundary: the device state is already right (it
                # promoted itself); only host bookkeeping moves.
                self._promos_since_heavy += len(new_kfs)
                self._ref_kf = kf_last
            info["new_keyframe"] = True
        else:
            self._frames_since_kf += n
        return self._chunk_tail(info, n_inl_all, outs, ts_tuple, "devpromo")

    def _run_chunk_devpromo_async(self, imgs, buf, n: int) -> dict:
        """Async boundary of the self-promoting chunk: the solve started at
        the previous boundary lands here (``_finish_async_solve``: writeback,
        loop closing, one correction of the device carry), this chunk's
        promotions are adopted in the corrected world, and this boundary's
        own solve is started to land at the next one. fsr and T_ref chain on
        the device between chunks; the host does not seed them."""
        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        self._track_state, self._dev_fsr, self._dev_T_ref, outs, recs = self._chunk(
            self._track_state, self._dev_fsr, self._dev_T_ref, self._stack_imgs(imgs), n_valid=n,
        )
        ts_tuple = tuple(t for _, t in buf)
        self.poses.append((ts_tuple, outs.T_w2c[:n], ref_kf, T_ref_snap))
        fetched = self._fetch_chunk(outs, recs, n)
        n_inl_all, promoted, T_all_np = fetched[4:]
        tcfg = self.config.tracking
        last = n - 1
        info = {"state": self.state.name, "n_inliers": int(n_inl_all[last]), "chunk_frames": n}
        if int(n_inl_all.min()) < 2 * tcfg.min_inliers:
            # Tracking thinned inside this chunk: the similarity correction
            # is too coarse near the edge, so the next boundaries run
            # synchronously (an exact post-BA reference install).
            self._async_cooloff = max(self._async_cooloff, tcfg.async_boundary_cooloff)
        U = self._finish_async_solve(correct_device=True)
        promo_idx = np.nonzero(promoted)[0]
        new_kfs = self._adopt_chunk(fetched, outs, ts_tuple, ref_kf, arena, U=U)
        if new_kfs:
            # The chunk's poses are in the world it tracked in: anchor its
            # frames to the promoted keyframes' poses there.
            self._anchor_chunk(ts_tuple, promo_idx, new_kfs, [np.asarray(T_all_np[f], np.float64) for f in promo_idx])
            kf_last = new_kfs[-1]
            self._ref_kf = kf_last
            self._frames_since_kf = last - int(promo_idx[-1])
            self._enforce_budget()
            if self._arena_size:
                self._refresh_arena()
            heavy = (tcfg.heavy_boundary_every <= 1
                     or self._promos_since_heavy + len(new_kfs) >= tcfg.heavy_boundary_every)
            if heavy and self.map.num_keyframes() > 2:
                self._promos_since_heavy = 0
                pending = self._start_ba(overlap=True)
                if pending is not None:
                    self._async_bnd = {"pending": pending, "anchor": kf_last, "T_pre": kf_last.T_w2c.copy()}
            else:
                self._promos_since_heavy += len(new_kfs)
            info["new_keyframe"] = True
        else:
            self._frames_since_kf += n
        return self._chunk_tail(info, n_inl_all, outs, ts_tuple, "async devpromo")

    def _finish_async_solve(self, correct_device: bool):
        """Land the solve started at the previous async boundary: write it
        back, run loop closing on its anchor keyframe and, with
        ``correct_device``, carry the device state into the post-solve world
        with one similarity correction (``pipeline.apply_correction``).
        Returns (R_u, t_u, s) when a correction other than the identity was
        applied, else None."""
        if self._async_bnd is None:
            return None
        ab, self._async_bnd = self._async_bnd, None
        anchor = ab["anchor"]
        g = self._finish_ba(ab["pending"])
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(anchor)
        if not correct_device:
            return None
        s = float(g[0]) if g is not None else 1.0
        R_u, t_u = correction_similarity(ab["T_pre"], anchor.T_w2c, s)
        if abs(s - 1.0) < 1e-12 and np.allclose(R_u, np.eye(3), atol=1e-12) and np.allclose(t_u, 0.0, atol=1e-12):
            return None
        self._track_state, self._dev_T_ref = apply_correction(self._track_state, self._dev_T_ref, R_u, t_u, s)
        return R_u, t_u, s

    def _new_keyframe(self, feats: Features, host_feats, timestamp: float, T) -> KeyFrame:
        """A keyframe around a (device) feature block, its host views taken
        from ``host_feats`` when the caller already fetched them."""
        frame = Frame(features=[feats], timestamp=timestamp)
        if host_feats is not None:
            frame.cache_host_features(host_feats)
        frame.update_pose(np.asarray(T, np.float64))
        return KeyFrame.from_frame(frame)

    def _fuse_double_links(self, kf: KeyFrame, ref: KeyFrame, arena, cand) -> None:
        """Fuse landmarks where keypoint i carries a guided-arena landmark
        (arena row g_idx[i]) and a different reference-block landmark (ref
        slot ti[i]) within 10% of its depth: one physical point tracked
        twice. ``cand`` holds (i, g_idx[i], ti[i]) triples."""
        C_kf = kf.camera_center
        for i, r, t in cand:
            if r >= len(arena):
                continue
            mp_a, mp_b = arena[r], ref.get_map_point(0, t)
            if mp_a is None or mp_b is None or mp_a is mp_b or mp_a.is_bad or mp_b.is_bad:
                continue
            d = float(np.linalg.norm(mp_a.position - mp_b.position))
            depth = float(np.linalg.norm(mp_a.position - C_kf))
            if d <= 0.1 * max(depth, 1e-6):
                keep, drop = ((mp_a, mp_b) if mp_a.num_observations() >= mp_b.num_observations() else (mp_b, mp_a))
                self.map.fuse_map_points(keep, drop)

    def _inherit(self, kf: KeyFrame, ref: KeyFrame, arena, ti, m_ok, inl, g_idx, g_ok):
        """Link the new keyframe's keypoints to existing landmarks: the
        guided arena association first (it is what PnP used), then the
        reference-block match; then fuse double links. Returns the mask of
        inheriting keypoints and ref's landmark mask from before the fusion."""
        _, ref_mask = ref.point_arrays(0)
        inherited = np.zeros(len(m_ok), bool)
        if len(arena):
            for i in np.nonzero(g_ok)[0]:
                r = int(g_idx[i])
                if r < len(arena):
                    mp = arena[r]
                    if mp is not None and not mp.is_bad:
                        kf.add_map_point(0, int(i), mp)
                        inherited[i] = True
        for i in np.nonzero(m_ok & inl & ref_mask[ti] & ~inherited)[0]:
            mp = ref.get_map_point(0, int(ti[i]))
            if mp is not None and not mp.is_bad:
                kf.add_map_point(0, int(i), mp)
                inherited[i] = True
        if len(arena):
            both = np.nonzero(g_ok & m_ok & ref_mask[ti])[0]
            self._fuse_double_links(kf, ref, arena, [(int(i), int(g_idx[i]), int(ti[i])) for i in both])
        return inherited, ref_mask

    def _adopt_device_keyframe(self, out, rec, timestamp: float, ref: KeyFrame, arena,
                               host_feats=None) -> KeyFrame:
        """Replay one in-chunk device promotion into the host map: the
        keyframe from the fetched outputs, landmarks inherited through the
        associations the device used, and MapPoints minted for the slots the
        device triangulated (positions from the PromoteRecord)."""
        kf = self._new_keyframe(out.features, host_feats, timestamp, _np(out.T_w2c))
        ti, m_ok, inl = _np(out.match_train_idx), _np(out.match_valid), _np(out.pnp_inliers)
        g_idx = _np(out.guided_idx)
        inherited, _ = self._inherit(kf, ref, arena, ti, m_ok, inl, g_idx, _np(out.guided_valid) & inl)
        # Mint only the slots the device triangulated: an inherited slot
        # whose host link failed above (arena landmark fused or culled since
        # the chunk ran) is dropped, not re-created; for a guided-only
        # association ti[i] is a meaningless train index.
        new_mask = _np(rec.ref_tri) & ~inherited
        dropped = int((_np(rec.ref_has) & ~inherited & ~new_mask).sum())
        pos = np.asarray(_np(rec.ref_pos), np.float64)
        desc = kf.descriptors(0)
        created = 0
        for i in np.nonzero(new_mask)[0]:
            mp = MapPoint(pos[i], descriptor=desc[i])
            kf.add_map_point(0, int(i), mp)
            # Back-link into the previous keyframe only through a valid match
            # onto a free slot.
            if m_ok[i] and ref.get_map_point(0, int(ti[i])) is None:
                ref.add_map_point(0, int(ti[i]), mp)
            self.map.add_map_point(mp)
            created += 1
        self.map.add_keyframe(kf)
        self.logger.debug("adopt devpromo KF: %d inherited, %d device-triangulated, %d stale-inherit dropped, "
                          "kf landmarks %d", int(inherited.sum()), created, dropped, kf.num_map_points())
        return kf

    def _enforce_budget(self) -> int:
        """Landmark-budget eviction (``config.map.max_landmarks``; LRU,
        recent keyframes' landmarks protected), before the BA pack, so the
        map stays inside one point bucket."""
        budget = self.config.map.max_landmarks
        if budget <= 0:
            return 0
        n = self.map.evict_landmarks(budget, protect_recent=self.config.map.budget_protect_recent)
        if n:
            self.logger.debug("landmark budget: evicted %d (map at %d / budget %d)", n,
                              self.map.num_map_points(), budget)
        return n

    def _start_ba(self, overlap: bool = False):
        """Start the boundary's solve: global over the whole map while it
        holds at most 2 x window_size keyframes, else the local window.
        None when there is nothing to solve. ``overlap``: the solve lands at
        a later boundary, so it runs beside the tracking (``solve_start``)."""
        if self.map.num_keyframes() <= 2:
            return None
        kfs = self.map.get_keyframes()
        if len(kfs) <= 2 * self.config.optimization.window_size:
            return self.optimizer.optimize_global_start(kfs, self.map.get_map_points(), overlap=overlap)
        return self._start_local_ba(kfs, overlap=overlap)

    def _finish_ba(self, pending):
        """Write back a started solve; returns its mono gauge similarity
        (s, b), recorded on the map, or None."""
        res = self.optimizer.solve_finish(pending)
        g = res.get("gauge_transform")
        if g is not None:
            self.map.record_gauge_transform(*g)
        return g

    def _boundary_heavy(self, kf: KeyFrame) -> None:
        """BA and loop closing of a self-promoting chunk's boundary; the
        device-triangulated landmarks are already in the map and join it."""
        pending = self._start_ba()
        if pending is not None:
            self._finish_ba(pending)
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(kf)

    def _apply_pending_ba(self) -> None:
        """Land every solve in flight: an async boundary's (with its device
        correction) and ``async_ba``'s."""
        self._finish_async_solve(correct_device=True)
        if self._ba_pending is None:
            return
        pending, self._ba_pending = self._ba_pending, None
        self._finish_ba(pending)

    def _start_local_ba(self, kfs, overlap: bool = False):
        window = kfs[-self.config.optimization.window_size:]
        points = {}
        for kf in window:
            for mp in list(kf.map_points.values()):
                if not mp.is_bad:
                    points[mp.id] = mp
        window_ids = {kf.keyframe_id for kf in window}
        anchor_ids = set()
        for mp in points.values():
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id not in window_ids:
                    anchor_ids.add(kf_id)
        anchors = [kf for kf in kfs if kf.keyframe_id in anchor_ids]
        return self.optimizer.optimize_local_start(window, list(points.values()), fixed_keyframes=anchors,
                                                   overlap=overlap)

    def _decide(self, out, timestamp, ref_kf, arena) -> dict:
        n_inl, n_match, T_prev = to_host((out.n_inliers, out.n_matches, out.T_w2c))
        n_inl = int(n_inl)
        info = {"n_inliers": n_inl, "n_matches": int(n_match)}
        tcfg = self.config.tracking
        if n_inl < tcfg.min_inliers:
            # Brute multi-keyframe matching before declaring LOST.
            rec = self._brute_recover(out, timestamp)
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            self._pending = None
            info["state"] = self.state.name
            self.logger.warning("compiled tracking lost (%d inliers)", n_inl)
            return info
        rot_deg, trans = _motion_from(np.asarray(T_prev, np.float64), ref_kf) if ref_kf is not None else (0.0, 0.0)
        if (
            self._frames_since_kf > tcfg.keyframe_interval
            or n_inl < tcfg.kf_min_matches
            or rot_deg > tcfg.kf_min_rotation_deg
            or trans > tcfg.kf_min_translation
        ):
            # The trigger reads the previous frame, but the keyframe is the
            # newest submitted frame unless that one is about to go LOST.
            if self._pending is not None:
                p_out, p_ts, p_ref, p_arena = self._pending
                if int(to_host(p_out.n_inliers)) >= tcfg.min_inliers:
                    self._pending = None
                    self._promote_keyframe(p_out, p_ts, p_ref, p_arena)
                else:
                    self._promote_keyframe(out, timestamp, ref_kf, arena)
            else:  # flush: the decided frame is the newest
                self._promote_keyframe(out, timestamp, ref_kf, arena)
            info["new_keyframe"] = True
        return info

    def _brute_recover(self, out, timestamp: float) -> Optional[dict]:
        """Rescue of a near-lost frame: brute-match its feature block
        against the last three keyframes (K2; best landmark per keypoint
        across them), re-solve PnP, and promote the frame."""
        tcfg = self.config.tracking
        feats = out.features
        host_feats = to_host(feats)
        Kslots = host_feats.xy.shape[0]
        best_dist = np.full(Kslots, np.inf, np.float32)
        pts3d = np.zeros((Kslots, 3), np.float32)
        pair_valid = np.zeros(Kslots, bool)
        lm_of_slot: dict[int, MapPoint] = {}
        for kf in reversed(self.map.get_keyframes()[-3:]):
            fr = kf.get_features(0)
            if fr is None:
                continue
            fr = to_device(fr, self.device)
            res = match_descriptors(feats.desc, fr.desc, feats.valid, fr.valid, feats.angle, fr.angle,
                                    ratio=0.8, cross_check=True)
            ti, ok, dist = to_host((res["train_idx"], res["valid"], res["distance"]))
            pos, mask = kf.point_arrays(0)
            take = ok & mask[ti] & (dist < best_dist)
            best_dist[take] = dist[take]
            pts3d[take] = pos[ti[take]]
            pair_valid |= take
            for i in np.nonzero(take)[0]:
                mp = kf.get_map_point(0, int(ti[i]))
                if mp is not None:
                    lm_of_slot[int(i)] = mp
        if int(pair_valid.sum()) < 6:
            return None
        gen = torch.Generator(device=self.device).manual_seed(int(timestamp * 1000) & 0x7FFFFFFF)
        pts_d, valid_d = to_device((pts3d, pair_valid), self.device)
        res = ransac_pnp(pts_d, normalize_points(self._Kinv, feats.xy), valid_d, gen, n_hyp=tcfg.pnp_hypotheses,
                         thresh=tcfg.pnp_threshold_px / self.camera.fx)
        ok, n_inl, T, inl, T_tracked = to_host((res["ok"], res["n_inliers"], res["T"], res["inliers"], out.T_w2c))
        n_inl = int(n_inl)
        if not bool(ok) or n_inl < tcfg.min_inliers:
            return None
        # Promote with the recovered associations; the pending frame was
        # tracked against the bad pose, so its decision is dropped.
        kf = self._new_keyframe(feats, host_feats, timestamp, T)
        self._anchor_frame(timestamp, kf, T_tracked)
        for i, mp in lm_of_slot.items():
            if inl[i] and not mp.is_bad:
                kf.add_map_point(0, i, mp)
        self.map.add_keyframe(kf)
        self._frames_since_kf = 0
        self._pending = None
        self._apply_pending_ba()
        if self.map.num_keyframes() > 2:
            kfs_all = self.map.get_keyframes()
            if len(kfs_all) <= 2 * self.config.optimization.window_size:
                self.map.optimize_global(self.optimizer)
            else:
                self.map.optimize_local(self.optimizer, kfs_all[-self.config.optimization.window_size:])
        self._install_reference(kf, T_init=kf.T_w2c)
        self.logger.info("brute-recovered near-lost frame (%d inliers)", n_inl)
        return {"recovered": True, "n_inliers": n_inl, "new_keyframe": True}

    def _promote_keyframe(self, out, timestamp: float, ref: KeyFrame, arena, heavy: bool = True,
                          host=None) -> None:
        """Keyframe boundary from the step's outputs: no re-detection, no
        extra matching. ``ref``/``arena`` are the blocks installed when this
        frame's step ran; ``host`` is a host copy of ``out`` when the caller
        already fetched it. ``heavy=False`` creates the keyframe, inherits
        landmarks and swaps the reference, and skips triangulation, BA and
        loop closing."""
        if host is None:
            host = to_host(out)
        T_tracked = T = np.asarray(host.T_w2c, np.float64)
        ti, m_ok, inl = np.asarray(host.match_train_idx), np.asarray(host.match_valid), np.asarray(host.pnp_inliers)
        g_idx, g_ok = np.asarray(host.guided_idx), np.asarray(host.guided_valid)
        # Land an in-flight BA writeback first and carry the tracked pose
        # through its reference's correction.
        T_ref_before = ref.T_w2c.copy()
        self._apply_pending_ba()
        if not np.array_equal(ref.T_w2c, T_ref_before):
            T = T @ np.linalg.inv(T_ref_before) @ ref.T_w2c
        kf = self._new_keyframe(out.features, host.features, timestamp, T)
        self._anchor_frame(timestamp, kf, T_tracked)
        inherited, ref_mask = self._inherit(kf, ref, arena, ti, m_ok, inl, g_idx, g_ok & inl)
        # New landmarks come from matched but landmark-less pairs.
        tri_mask = m_ok & ~ref_mask[ti] & ~inherited if heavy else None
        # Stereo: a metric landmark for every depth-measured keypoint still
        # without one. tri_mask above predates them, as in the JAX package,
        # so the boundary triangulation below may write over such a slot.
        if heavy and self._stereo and host.kp_z is not None:
            self._create_stereo_points(kf, host)
        self.map.add_keyframe(kf)
        self._frames_since_kf = 0
        self._enforce_budget()
        created = 0
        if heavy and self._async_ba:
            # The solve lands at the next boundary; the new landmarks are
            # triangulated from the pre-solve poses the next frames track in.
            self._ba_pending = self._start_ba(overlap=True)
            if tri_mask.any():
                pts_np, good_np = to_host(self._triangulate_dispatch(kf, ref, ti))
                created = self._insert_triangulated(kf, ref, ti, tri_mask, pts_np, good_np)
            if self.loop_closing is not None:
                self.loop_closing.process_keyframe(kf)
        elif heavy:
            # The solve starts first (it excludes the new triangulations,
            # which join the next one); triangulation chains on the solve's
            # device output poses for ref and kf, so the new landmarks are
            # born in the post-solve frame; one fetch brings both.
            pending = self._start_ba()
            T_ref_dev = T_kf_dev = None
            if pending is not None:
                j_ref, j_kf = pending["kf_slot"].get(ref.keyframe_id), pending["kf_slot"].get(kf.keyframe_id)
                if j_ref is not None and j_kf is not None:
                    T_ref_dev, T_kf_dev = pending["T"][j_ref], pending["T"][j_kf]
            tri_dev = (self._triangulate_dispatch(kf, ref, ti, T_ref=T_ref_dev, T_kf=T_kf_dev)
                       if tri_mask.any() else None)
            fetched = to_host((tri_dev, None if pending is None else (pending["T"], pending["X"], pending["info"])))
            gauge = None
            if pending is not None:
                pending["T"], pending["X"], pending["info"] = fetched[1]
                res = self.optimizer.solve_finish(pending)
                gauge = res.get("gauge_transform")
                if gauge is not None:
                    self.map.record_gauge_transform(*gauge)
            if tri_dev is not None:
                pts_np, good_np = fetched[0]
                if gauge is not None:
                    # Carry the points through the gauge similarity applied
                    # to the poses they were triangulated from.
                    s, b = gauge
                    pts_np = s * np.asarray(pts_np) + b
                created = self._insert_triangulated(kf, ref, ti, tri_mask, pts_np, good_np)
            if self.loop_closing is not None:
                self.loop_closing.process_keyframe(kf)
        self._install_reference(kf, T_init=kf.T_w2c if self.map.num_keyframes() > 2 else T)
        self.logger.debug("promote(%s): %d matches (%d to landmarks), %d inherited, %d triangulated, kf landmarks %d",
                          "heavy" if heavy else "light", int(m_ok.sum()), int((m_ok & ref_mask[ti]).sum()),
                          int(inherited.sum()), created, kf.num_map_points())

    def _create_stereo_points(self, kf: KeyFrame, host) -> int:
        """Mint a landmark, back-projected from its disparity depth, for
        every valid keypoint of ``kf`` with min_depth < z < max_depth and no
        landmark yet; ``host`` is the step output's host copy. Sets
        ``kf.kp_z`` / ``kf.kp_z_valid``. Returns the number minted."""
        lcfg = self.config.local_mapping
        z = np.asarray(host.kp_z)
        ok = np.asarray(host.kp_z_valid) & kf.valid_mask(0) & (z > lcfg.min_depth) & (z < lcfg.max_depth)
        kf.kp_z, kf.kp_z_valid = z, ok
        p_w = backproject_np(self.camera.Kinv, kf.R_c2w, kf.t_c2w, kf.keypoints(0), z)
        desc = kf.descriptors(0)
        created = 0
        for i in np.nonzero(ok)[0]:
            if kf.get_map_point(0, int(i)) is None:
                mp = MapPoint(p_w[i], descriptor=desc[i])
                kf.add_map_point(0, int(i), mp)
                self.map.add_map_point(mp)
                created += 1
        return created

    def _triangulate_dispatch(self, kf: KeyFrame, ref: KeyFrame, ti, T_ref=None, T_kf=None):
        """Start the boundary triangulation (``triangulate_gated``) of kf's
        keypoints against their ref matches; ``T_ref``/``T_kf`` override the
        poses with device tensors (the solve's output slots). Returns device
        (pts3d, good)."""
        lcfg = self.config.local_mapping
        T_ref = self._dev_pose(ref.T_w2c) if T_ref is None else T_ref
        T_kf = self._dev_pose(kf.T_w2c) if T_kf is None else T_kf
        xy_ref, xy_kf = to_device((ref.keypoints(0)[np.asarray(ti)], kf.keypoints(0)), self.device)
        thr = to_device(np.array([lcfg.min_depth, lcfg.max_depth, np.deg2rad(lcfg.min_parallax_deg),
                                  self.config.tracking.pnp_threshold_px / float(self.camera.fx)], np.float32),
                        self.device)
        return triangulate_gated(self._Kinv, T_ref, T_kf, xy_ref, xy_kf, thr[0], thr[1], thr[2], thr[3])

    def _insert_triangulated(self, kf, ref, ti, tri_mask, pts_np, good_np) -> int:
        good_np = np.asarray(good_np) & tri_mask
        pts_np = np.asarray(pts_np)
        desc_np = kf.descriptors(0)
        created = 0
        for i in np.nonzero(good_np)[0]:
            mp = MapPoint(pts_np[i], descriptor=desc_np[i])
            kf.add_map_point(0, int(i), mp)
            ref.add_map_point(0, int(ti[i]), mp)
            self.map.add_map_point(mp)
            created += 1
        return created
