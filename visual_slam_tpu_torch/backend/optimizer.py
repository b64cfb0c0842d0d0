"""Optimizer facade: packs host map objects into fixed-shape BA problems,
runs the LM/Schur solver on the device, writes the results back
(port of ``visual_slam_tpu.backend.optimizer``).

``optimize_initial`` (two-view), ``optimize_local`` (window with fixed
anchors) and ``optimize_global`` (all keyframes, mono gauge re-imposed),
and their ``_start`` variants, which dispatch the solve without waiting
and return a handle that ``solve_finish`` fetches (one host
synchronisation) and writes back. With ``overlap=True`` a solve on the
card runs on a side CUDA stream, so the host synchronisations of the
tracking launched meanwhile on the main stream do not wait for it;
``solve_finish`` makes the main stream wait on its event before the
fetch. Shapes are bucketed so a run keeps few distinct problem sizes.

Two layouts: the dense (M, W) grid and, with ``optimization.sparse_obs``,
the sparse landmark-major one (``obs_cap`` observation slots a landmark;
a landmark seen more often in the window keeps an evenly spread subset
for that solve). ``sparse_obs="auto"`` takes the sparse layout from a pose
bucket of ``sparse_auto_min_window`` on, the JAX package's rule for every
backend but the TPU. ``optimization.lm_minor`` is accepted and solves on
the dense grid: the JAX package's landmark-minor layout is the same math
laid out for the TPU's tiling (``backend.ba.bundle_adjust_robust_lm``).
"""
from __future__ import annotations

import abc
import contextlib
import logging
from typing import List, Sequence

import numpy as np
import torch

from ..config import Config
from ..map.keyframe import KeyFrame
from ..map.map_point import MapPoint
from ..utils.device import default_device
from ..utils.tree import to_device, to_host
from .ba import BAProblem, BASparse, bundle_adjust_robust, bundle_adjust_robust_sparse


class BaseOptimizer(abc.ABC):
    def __init__(self, config: Config, camera, logger: logging.Logger | None = None, device=None):
        self.config = config
        self.camera = camera
        self.logger = logger or logging.getLogger(self.__class__.__name__)
        self.device = default_device(device)

    @abc.abstractmethod
    def optimize_initial(self, keyframes: Sequence[KeyFrame]) -> dict: ...

    @abc.abstractmethod
    def optimize_local(self, keyframes: Sequence[KeyFrame], map_points: Sequence[MapPoint]) -> dict: ...

    @abc.abstractmethod
    def optimize_global(self, keyframes: Sequence[KeyFrame], map_points: Sequence[MapPoint]) -> dict: ...


def _next_pow2(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _bucket4(n: int, lo: int) -> int:
    """Next bucket in a x4 ladder (lo, 4lo, 16lo, ...): few distinct shapes."""
    v = lo
    while v < n:
        v *= 4
    return v


class LMOptimizer(BaseOptimizer):
    """Levenberg-Marquardt + Schur bundle adjustment (the primary solver),
    on ``device``."""

    @staticmethod
    def _pack_poses(keyframes: List[KeyFrame], W: int, fixed_flags: List[bool]):
        """The pose slots of either layout: (T_w2c (W, 4, 4), pose_valid,
        pose_fixed, {keyframe_id: slot})."""
        T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        pose_valid = np.zeros(W, bool)
        for j, kf in enumerate(keyframes):
            T[j] = kf.T_w2c
            pose_valid[j] = True
        pose_fixed = np.zeros(W, bool)
        pose_fixed[: len(fixed_flags)] = fixed_flags
        return T, pose_valid, pose_fixed, {kf.keyframe_id: j for j, kf in enumerate(keyframes)}

    def _pack(self, keyframes: List[KeyFrame], map_points: List[MapPoint], w_bucket: int, m_bucket: int,
              fixed_flags: List[bool]):
        """Host numpy arrays of the (m_bucket, w_bucket) problem, the points
        packed, the keyframe slots, the packed observation mask and the
        keypoint index of each packed observation."""
        W, M = w_bucket, m_bucket
        Kinv = np.linalg.inv(np.asarray(self.camera.K, np.float64))
        T, pose_valid, pose_fixed, kf_slot = self._pack_poses(keyframes, W, fixed_flags)
        pts = np.zeros((M, 3), np.float32)
        uv = np.zeros((M, W, 2), np.float32)
        obs_valid = np.zeros((M, W), bool)
        kp_of = np.full((M, W), -1, np.int32)
        used_points: List[MapPoint] = list(map_points[:M])
        ii: List[int] = []
        jj: List[int] = []
        kk: List[int] = []
        for i, mp in enumerate(used_points):
            pts[i] = mp.position
            for kf_id, cam_id, kp_idx in mp.observations.items():
                j = kf_slot.get(kf_id)
                if j is None or cam_id != 0:
                    continue
                ii.append(i)
                jj.append(j)
                kk.append(kp_idx)
        if ii:
            ia, ja, ka = np.asarray(ii), np.asarray(jj), np.asarray(kk)
            kp_all = np.stack([kf.keypoints(0) for kf in keyframes])  # (Wr, K, 2)
            uv[ia, ja] = kp_all[ja, ka] @ Kinv[:2, :2].T + Kinv[:2, 2]
            obs_valid[ia, ja] = True
            kp_of[ia, ja] = ka
        problem = BAProblem(T_w2c=T, points=pts, uv=uv, obs_valid=obs_valid, pose_valid=pose_valid,
                            pose_fixed=pose_fixed)
        return problem, used_points, kf_slot, obs_valid, kp_of

    def _pack_sparse(self, keyframes: List[KeyFrame], map_points: List[MapPoint], w_bucket: int, m_bucket: int,
                     fixed_flags: List[bool]):
        """Host numpy arrays of the landmark-major problem (``obs_cap``
        slots a landmark), the points packed, the keyframe slots, the
        packed observation mask, the keypoint index and the pose slot of
        each packed observation. A landmark with more than ``obs_cap``
        observations in the window keeps an evenly spread subset, and the
        count of such landmarks is logged."""
        W, M = w_bucket, m_bucket
        K = self.config.optimization.obs_cap
        Kinv = np.linalg.inv(np.asarray(self.camera.K, np.float64))
        T, pose_valid, pose_fixed, kf_slot = self._pack_poses(keyframes, W, fixed_flags)
        pts = np.zeros((M, 3), np.float32)
        uv = np.zeros((M, K, 2), np.float32)
        obs_pose = np.zeros((M, K), np.int32)
        obs_valid = np.zeros((M, K), bool)
        kp_of = np.full((M, K), -1, np.int32)
        used_points: List[MapPoint] = list(map_points[:M])
        ii: List[int] = []
        ss: List[int] = []
        jj: List[int] = []
        kk: List[int] = []
        n_over = 0
        for i, mp in enumerate(used_points):
            pts[i] = mp.position
            obs = [(kf_slot[kf_id], kp_idx) for kf_id, cam_id, kp_idx in mp.observations.items()
                   if cam_id == 0 and kf_id in kf_slot]
            if len(obs) > K:
                n_over += 1
                obs = [obs[q] for q in np.unique(np.round(np.linspace(0, len(obs) - 1, K)).astype(int))]
            for k, (j, kp_idx) in enumerate(obs):
                ii.append(i)
                ss.append(k)
                jj.append(j)
                kk.append(kp_idx)
        if n_over:
            self.logger.debug("sparse BA pack: %d landmarks exceed obs_cap=%d this window (evenly-spread subset "
                              "kept)", n_over, K)
        if ii:
            ia, sa, ja, ka = np.asarray(ii), np.asarray(ss), np.asarray(jj), np.asarray(kk)
            kp_all = np.stack([kf.keypoints(0) for kf in keyframes])
            uv[ia, sa] = kp_all[ja, ka] @ Kinv[:2, :2].T + Kinv[:2, 2]
            obs_pose[ia, sa] = ja
            obs_valid[ia, sa] = True
            kp_of[ia, sa] = ka
        problem = BASparse(T_w2c=T, points=pts, uv=uv, obs_pose=obs_pose, obs_valid=obs_valid,
                           pose_valid=pose_valid, pose_fixed=pose_fixed)
        return problem, used_points, kf_slot, obs_valid, kp_of, obs_pose

    def _select_points(self, map_points, cap: int):
        """Respect the landmark cap by keeping the best-observed points, and
        say so: dropped landmarks are neither optimized nor trimmed."""
        if len(map_points) <= cap:
            return map_points
        ranked = sorted(map_points, key=lambda mp: -mp.num_observations())
        self.logger.warning(
            "BA landmark cap: optimizing the %d best-observed of %d landmarks "
            "(%d dropped this solve; raise config.optimization.max_points to include them)",
            cap, len(map_points), len(map_points) - cap,
        )
        return ranked[:cap]

    @staticmethod
    def _reimpose_mono_gauge(T_np, X_np, keyframes, fixed_flags):
        """Mono gauge re-projection: with only KF0 fixed, SCALE is a null
        direction of the cost and f32 LM steps random-walk along it. A
        similarity about KF0's camera center leaves every reprojection
        invariant, so re-impose the pre-solve KF0->KF1 baseline length
        exactly. Mutates T_np in place; returns the re-scaled X_np plus the
        applied similarity as (s, b) with x -> s*x + b (None if nothing was
        applied) so callers can version it on the map."""
        def center(Tm):
            return -Tm[:3, :3].T @ Tm[:3, 3]

        C0 = center(T_np[0])
        d_before = np.linalg.norm(np.asarray(keyframes[1].t_c2w) - np.asarray(keyframes[0].t_c2w))
        d_after = np.linalg.norm(center(T_np[1]) - C0)
        if d_after > 1e-9 and d_before > 1e-9:
            s = d_before / d_after
            for j in range(len(keyframes)):
                if fixed_flags[j]:
                    continue
                Cj = C0 + s * (center(T_np[j]) - C0)
                T_np[j, :3, 3] = -T_np[j, :3, :3] @ Cj
            X_np = C0 + s * (X_np - C0)
            return X_np, (s, (1.0 - s) * C0)
        return X_np, None

    def _use_sparse(self, w_bucket: int) -> bool:
        """The layout of a solve with pose bucket ``w_bucket``: sparse with
        ``sparse_obs=True``, or with ``"auto"`` from ``sparse_auto_min_window``
        on."""
        cfg = self.config.optimization
        if cfg.sparse_obs == "auto":
            return w_bucket >= cfg.sparse_auto_min_window
        return bool(cfg.sparse_obs)

    def solve_start(self, keyframes, map_points, w_bucket, fixed_flags=None, renormalize_scale=False,
                    overlap: bool = False):
        """Pack, upload and start the LM/Schur solve without waiting
        (``overlap``: on the card, on the side stream). Returns the pending
        handle for :meth:`solve_finish`; its ``problem`` holds the packed
        numpy arrays (``BAProblem``, or ``BASparse`` when ``sparse`` is
        True)."""
        cfg = self.config.optimization
        sparse = self._use_sparse(w_bucket)
        if fixed_flags is None:
            fixed_flags = [j == 0 for j in range(len(keyframes))]  # gauge: first KF frozen
        map_points = self._select_points(map_points, cfg.max_points)
        m_bucket = min(_bucket4(len(map_points), lo=cfg.point_bucket_floor),
                       max(cfg.max_points, cfg.point_bucket_floor))
        focal = float(self.camera.K[0, 0])
        n1 = max(cfg.n_iter // 2, 1)
        if not hasattr(self, "shapes_seen"):
            self.shapes_seen = set()
        self.shapes_seen.add((w_bucket, m_bucket))
        obs_pose = None
        if sparse:
            problem, used_points, kf_slot, packed_valid, kp_of, obs_pose = self._pack_sparse(
                keyframes, map_points, w_bucket, m_bucket, fixed_flags)
            solve = bundle_adjust_robust_sparse
        else:
            problem, used_points, kf_slot, packed_valid, kp_of = self._pack(
                keyframes, map_points, w_bucket, m_bucket, fixed_flags)
            solve = bundle_adjust_robust
        stream = None
        if overlap and self.device.type == "cuda":
            if getattr(self, "_side_stream", None) is None:
                self._side_stream = torch.cuda.Stream(self.device)
            stream = self._side_stream
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            T, X, info = solve(to_device(problem, self.device), n_iter=n1, n_iter2=max(cfg.n_iter - n1, 1),
                               huber=cfg.huber_delta / focal, lam0=cfg.lm_lambda0, trim_factor=3.0)
        ready = None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
        return {
            "T": T, "X": X, "info": info, "problem": problem, "sparse": sparse, "ready": ready,
            "keyframes": list(keyframes), "used_points": used_points,
            "kf_slot": kf_slot, "packed_valid": packed_valid, "kp_of": kp_of, "obs_pose": obs_pose,
            "fixed_flags": fixed_flags, "renormalize_scale": renormalize_scale,
        }

    def solve_finish(self, pending: dict) -> dict:
        """Fetch (one synchronisation) and write back a :meth:`solve_start`
        dispatch. Keyframes or landmarks culled meanwhile are written
        harmlessly: the map reads only live ones."""
        keyframes = pending["keyframes"]
        used_points = pending["used_points"]
        packed_valid = pending["packed_valid"]
        kp_of = pending["kp_of"]
        fixed_flags = pending["fixed_flags"]
        info = pending["info"]
        if pending.get("ready") is not None:
            # Solved on the side stream: the main stream waits for it, and the
            # outputs (allocated there) are marked in use on the main stream,
            # so the allocator keeps them until the fetch below has read them.
            main = torch.cuda.current_stream(self.device)
            main.wait_event(pending["ready"])
            for t in (pending["T"], pending["X"], *info.values()):
                t.record_stream(main)
        T_np, X_np, cost0, cost, kept, n_trimmed = to_host(
            (pending["T"], pending["X"], info["cost0"], info["cost"], info["obs_kept"], info["n_trimmed"])
        )
        T_np = np.array(T_np)  # writable: the gauge re-projection mutates it
        X_np = np.array(X_np)
        gauge_transform = None
        if pending["renormalize_scale"] and len(keyframes) >= 2:
            X_np, gauge_transform = self._reimpose_mono_gauge(T_np, X_np, keyframes, fixed_flags)
        for j, kf in enumerate(keyframes):
            if not kf.is_fixed and not fixed_flags[j]:
                kf.update_pose(T_np[j].astype(np.float64))
        X64 = X_np.astype(np.float64)
        for i, mp in enumerate(used_points):
            mp.position = X64[i]
        # Drop the observations the solver rejected; only the removed set is
        # iterated.
        removed = packed_valid & ~np.asarray(kept)
        obs_pose = pending["obs_pose"]
        for i, j in zip(*np.nonzero(removed)):
            # Sparse: j is the observation slot and obs_pose its pose slot.
            kf = keyframes[j if obs_pose is None else int(obs_pose[i, j])]
            mp, kp_idx = used_points[i], int(kp_of[i, j])
            # Only the link the solver judged: fusion may have re-pointed the
            # slot at another landmark since the pack.
            if kf.get_map_point(0, kp_idx) is mp:
                kf.remove_map_point(0, kp_idx)
        for i in set(np.nonzero(removed)[0].tolist()):
            # Only fully orphaned landmarks die here: single-observation
            # points still serve PnP tracking.
            if used_points[i].num_observations() < 1:
                used_points[i].set_bad()
        return {
            "cost0": float(cost0),
            "cost": float(cost),
            "n_trimmed": int(n_trimmed),
            "n_points": len(used_points),
            "n_keyframes": len(keyframes),
            "gauge_transform": gauge_transform,
        }

    def _solve_and_writeback(self, keyframes, map_points, w_bucket, fixed_flags=None, renormalize_scale=False):
        return self.solve_finish(self.solve_start(keyframes, map_points, w_bucket, fixed_flags=fixed_flags,
                                                  renormalize_scale=renormalize_scale))

    def _cap_anchors(self, anchors, window, pts):
        """Bound the out-of-window fixed anchors so the pose bucket never
        grows past ``pose_bucket_floor``: keep the anchors sharing the most
        observations with the window's landmarks."""
        cap = max(0, self.config.optimization.pose_bucket_floor - len(window))
        if len(anchors) <= cap:
            return anchors
        counts = {a.keyframe_id: 0 for a in anchors}
        for mp in pts:
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id in counts:
                    counts[kf_id] += 1
        kept = sorted(anchors, key=lambda a: -counts[a.keyframe_id])[:cap]
        self.logger.debug("BA anchor cap: keeping the %d best-connected of %d anchors (pose bucket held at %d)",
                          cap, len(anchors), self.config.optimization.pose_bucket_floor)
        return kept

    def _local_args(self, keyframes, map_points, fixed_keyframes):
        """(all_kfs, points, w_bucket, fixed flags) of a window solve, or
        None when it is skipped."""
        kfs = list(keyframes)
        anchors = [kf for kf in fixed_keyframes if kf not in kfs]
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return None
        anchors = self._cap_anchors(anchors, kfs, pts)
        all_kfs = anchors + kfs
        fixed = [True] * len(anchors) + [False] * len(kfs)
        if not anchors:
            fixed[0] = True  # gauge
        w_bucket = _bucket4(max(self.config.optimization.window_size, len(all_kfs)),
                            lo=self.config.optimization.pose_bucket_floor)
        return all_kfs, pts, w_bucket, fixed

    def _global_args(self, keyframes, map_points):
        kfs = list(keyframes)
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return None
        return kfs, pts, _bucket4(len(kfs), lo=self.config.optimization.pose_bucket_floor)

    # -- public entry points ------------------------------------------------
    def optimize_initial(self, keyframes):
        kfs = list(keyframes)
        if len(kfs) < 2:
            return {"skipped": True}
        points = {}
        for kf in kfs:
            for mp in list(kf.map_points.values()):
                if not mp.is_bad:
                    points[mp.id] = mp
        if len(points) < 10:
            return {"skipped": True}
        # No scale renormalization: the two-view solve barely moves the gauge.
        return self._solve_and_writeback(kfs, list(points.values()), w_bucket=2)

    def optimize_local(self, keyframes, map_points, fixed_keyframes=()):
        """Window BA; ``fixed_keyframes`` are out-of-window anchors observing
        window landmarks, joined with frozen poses."""
        args = self._local_args(keyframes, map_points, fixed_keyframes)
        if args is None:
            return {"skipped": True}
        all_kfs, pts, w_bucket, fixed = args
        return self._solve_and_writeback(all_kfs, pts, w_bucket=w_bucket, fixed_flags=fixed)

    def optimize_local_start(self, keyframes, map_points, fixed_keyframes=(), overlap: bool = False):
        """:meth:`optimize_local` without waiting; None when skipped."""
        args = self._local_args(keyframes, map_points, fixed_keyframes)
        if args is None:
            return None
        all_kfs, pts, w_bucket, fixed = args
        return self.solve_start(all_kfs, pts, w_bucket=w_bucket, fixed_flags=fixed, overlap=overlap)

    def optimize_global_start(self, keyframes, map_points, overlap: bool = False):
        """:meth:`optimize_global` without waiting (the gauge is re-imposed
        at finish); None when skipped."""
        args = self._global_args(keyframes, map_points)
        if args is None:
            return None
        kfs, pts, w_bucket = args
        return self.solve_start(kfs, pts, w_bucket=w_bucket, renormalize_scale=True, overlap=overlap)

    def optimize_global(self, keyframes, map_points):
        args = self._global_args(keyframes, map_points)
        if args is None:
            return {"skipped": True}
        kfs, pts, w_bucket = args
        return self._solve_and_writeback(kfs, pts, w_bucket=w_bucket, renormalize_scale=True)
