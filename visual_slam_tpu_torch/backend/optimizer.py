"""Optimizer facade: packs host map objects into fixed-shape BA problems,
runs the LM/Schur solver on the device, writes the results back
(port of ``visual_slam_tpu.backend.optimizer``).

``optimize_initial`` (two-view), ``optimize_local`` (window with fixed
anchors) and ``optimize_global`` (all keyframes, mono gauge re-imposed),
and their ``_start`` variants, which dispatch the solve without waiting
and return a handle that ``solve_finish`` fetches (one host
synchronisation) and writes back. Shapes are bucketed so a run keeps few
distinct problem sizes.

Only the dense layout is ported: ``sparse_obs=True`` (or ``"auto"`` where
it would pick the sparse layout) and ``lm_minor=True`` raise
``NotImplementedError``; ``lm_minor="auto"`` resolves to False, since the
landmark-minor layout exists for the TPU's tiling.
"""
from __future__ import annotations

import abc
import logging
from typing import List, Sequence

import numpy as np

from ..config import Config
from ..map.keyframe import KeyFrame
from ..map.map_point import MapPoint
from ..utils.device import default_device
from ..utils.tree import to_device, to_host
from .ba import BAProblem, bundle_adjust_robust


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

    def _pack(self, keyframes: List[KeyFrame], map_points: List[MapPoint], w_bucket: int, m_bucket: int,
              fixed_flags: List[bool]):
        """Host numpy arrays of the (m_bucket, w_bucket) problem, the points
        packed, the keyframe slots, the packed observation mask and the
        keypoint index of each packed observation."""
        W, M = w_bucket, m_bucket
        Kinv = np.linalg.inv(np.asarray(self.camera.K, np.float64))
        kf_slot = {kf.keyframe_id: j for j, kf in enumerate(keyframes)}
        T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        pose_valid = np.zeros(W, bool)
        for j, kf in enumerate(keyframes):
            T[j] = kf.T_w2c
            pose_valid[j] = True
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
        pose_fixed = np.zeros(W, bool)
        pose_fixed[: len(fixed_flags)] = fixed_flags
        problem = BAProblem(T_w2c=T, points=pts, uv=uv, obs_valid=obs_valid, pose_valid=pose_valid,
                            pose_fixed=pose_fixed)
        return problem, used_points, kf_slot, obs_valid, kp_of

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

    def _check_layout(self, w_bucket: int) -> None:
        cfg = self.config.optimization
        sparse = cfg.sparse_obs
        if sparse == "auto":
            # The JAX package picks the sparse layout off the TPU from this
            # window on; it is not ported.
            sparse = w_bucket >= cfg.sparse_auto_min_window
        if sparse:
            raise NotImplementedError("sparse (landmark-major) bundle adjustment is not ported yet")
        if cfg.lm_minor != "auto" and bool(cfg.lm_minor):
            raise NotImplementedError("landmark-minor bundle adjustment is not ported yet")

    def solve_start(self, keyframes, map_points, w_bucket, fixed_flags=None, renormalize_scale=False):
        """Pack, upload and start the LM/Schur solve without waiting.
        Returns the pending handle for :meth:`solve_finish`; its
        ``problem`` holds the packed numpy arrays."""
        cfg = self.config.optimization
        self._check_layout(w_bucket)
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
        problem, used_points, kf_slot, packed_valid, kp_of = self._pack(
            keyframes, map_points, w_bucket, m_bucket, fixed_flags
        )
        T, X, info = bundle_adjust_robust(
            to_device(problem, self.device), n_iter=n1, n_iter2=max(cfg.n_iter - n1, 1),
            huber=cfg.huber_delta / focal, lam0=cfg.lm_lambda0, trim_factor=3.0,
        )
        return {
            "T": T, "X": X, "info": info, "problem": problem,
            "keyframes": list(keyframes), "used_points": used_points,
            "kf_slot": kf_slot, "packed_valid": packed_valid, "kp_of": kp_of,
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
        for i, j in zip(*np.nonzero(removed)):
            kf, mp, kp_idx = keyframes[j], used_points[i], int(kp_of[i, j])
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

    def optimize_local_start(self, keyframes, map_points, fixed_keyframes=()):
        """:meth:`optimize_local` without waiting; None when skipped."""
        args = self._local_args(keyframes, map_points, fixed_keyframes)
        if args is None:
            return None
        all_kfs, pts, w_bucket, fixed = args
        return self.solve_start(all_kfs, pts, w_bucket=w_bucket, fixed_flags=fixed)

    def optimize_global_start(self, keyframes, map_points):
        """:meth:`optimize_global` without waiting (the gauge is re-imposed
        at finish); None when skipped."""
        args = self._global_args(keyframes, map_points)
        if args is None:
            return None
        kfs, pts, w_bucket = args
        return self.solve_start(kfs, pts, w_bucket=w_bucket, renormalize_scale=True)

    def optimize_global(self, keyframes, map_points):
        args = self._global_args(keyframes, map_points)
        if args is None:
            return {"skipped": True}
        kfs, pts, w_bucket = args
        return self._solve_and_writeback(kfs, pts, w_bucket=w_bucket, renormalize_scale=True)
