"""Loop detection and closure (port of ``visual_slam_tpu.loop_closing.loop_closing``).

Detection shortlists old keyframes by global signature, then matches the
query keyframe's descriptors against every shortlisted keyframe in one K4
launch (``match_descriptors_batched``: candidate blocks stacked on the
features' device and padded to a power-of-two bucket of at least 64).
Candidates are gated to exclude the recent window and ranked by
ratio-test match count; the top two are verified in order by RANSAC-PnP
against their landmarks. A verified loop gives a corrected pose, a measured
relative scale (median depth ratio over PnP-inlier landmark pairs) and a
Sim(3) essential-graph optimization over odometry, covisibility and loop
edges, run on the same device; the landmarks and keyframe poses are then
corrected on the host. Global BA after a closure runs through the map's
``optimize_global`` when an optimizer is given; the port has none yet.

Host bookkeeping (map, ids, covisibility counts, landmark correction) is
numpy, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..map import KeyFrame, Map
from ..ops.matching import match_descriptors_batched
from ..ops.pnp import ransac_pnp
from ..ops.projection import normalize_points
from .pose_graph import build_sequential_graph, build_sim3_graph, optimize_pose_graph, optimize_sim3_graph
from .signature import batch_signatures, keyframe_signature, score_signatures


def _bucket(n: int, floor: int = 64) -> int:
    """Next power-of-two capacity >= n for the candidate axis (floor 64)."""
    c = floor
    while c < n:
        c *= 2
    return c


class LoopClosing:
    def __init__(
        self,
        slam_map: Map,
        camera,
        config,
        optimizer=None,
        min_gap: int = 10,
        min_matches: int = 40,
        min_inliers: int = 20,
        cooldown: int = 10,
        logger: Optional[logging.Logger] = None,
    ):
        self.map = slam_map
        self.camera = camera
        self.config = config
        self.optimizer = optimizer
        self.min_gap = min_gap  # exclude this many most-recent KFs
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.logger = logger or logging.getLogger("loop_closing")
        # RANSAC draws: seeded with 99 (the JAX PRNGKey(99)) on the
        # features' device at the first verification.
        self._gen: torch.Generator | None = None
        self.closed_loops: list[tuple[int, int]] = []
        # No detection for ``cooldown`` keyframes after a closure: one
        # revisit corrects the map once.
        self.cooldown = cooldown
        self._last_closed_kf_id: int = -(1 << 30)
        # kf_id -> (desc, valid, angle) tensors on the features' device
        # (features are immutable), stacked without a host round trip.
        self._feat_cache: dict[int, tuple] = {}
        self.shortlist_size = int(getattr(config.loop_closing, "shortlist_size", 8) or 8)
        self.use_signature = bool(getattr(config.loop_closing, "use_signature", True))
        self._sig_table: dict[int, np.ndarray] = {}  # kf_id -> (V,)
        # The last detect's funnel: shortlisted keyframe ids, their match
        # counts, and the PnP inliers of each verified candidate.
        self.funnel: dict = {}

    def note_signature(self, kf_id: int, sig) -> None:
        """Record an externally computed global signature for ``kf_id``."""
        self._sig_table[int(kf_id)] = np.asarray(sig, np.float32)

    # -- detection ---------------------------------------------------------
    def detect(self, kf: KeyFrame) -> Optional[dict]:
        """Best verified loop candidate for ``kf``, or None: one K4 launch
        scores every candidate; the top two by match count are verified in
        order."""
        self.funnel = {}
        kfs = self.map.get_keyframes()
        # Evict cache entries of culled/fused keyframes once the dead share
        # is noticeable.
        if len(self._sig_table) > len(kfs) + 64 or len(self._feat_cache) > len(kfs) + 64:
            live = {k.keyframe_id for k in kfs}
            for table in (self._sig_table, self._feat_cache):
                for kf_id in [k for k in table if k not in live]:
                    del table[kf_id]
        if len(kfs) <= self.min_gap + 1:
            return None
        candidates = [
            k for k in kfs[: -self.min_gap]
            if k.keyframe_id != kf.keyframe_id and k.get_features(0) is not None
        ]
        if not candidates:
            return None
        f_q = kf.get_features(0)
        if self.use_signature:
            candidates = self._signature_shortlist(kf, candidates)
            if not candidates:
                return None
        C = len(candidates)
        Cpad = _bucket(C)
        feats = []
        for c in candidates:
            cached = self._feat_cache.get(c.keyframe_id)
            if cached is None:
                fc = c.get_features(0)
                cached = self._feat_cache[c.keyframe_id] = (fc.desc, fc.valid, fc.angle)
            feats.append(cached)
        # Padding blocks copy candidate 0's descriptors with all-invalid masks.
        pad = Cpad - C
        desc_c = torch.stack([f[0] for f in feats] + [feats[0][0]] * pad)
        valid_c = torch.stack([f[1] for f in feats] + [torch.zeros_like(feats[0][1])] * pad)
        angle_c = torch.stack([f[2] for f in feats] + [feats[0][2]] * pad)
        res = match_descriptors_batched(
            f_q.desc, desc_c, f_q.valid, valid_c, f_q.angle, angle_c,
            ratio=0.75, cross_check=True, use_orientation=True,
        )
        counts = res["n_matches"][:C].cpu().numpy()
        self.funnel = {"shortlist": [c.keyframe_id for c in candidates], "n_matches": counts.tolist(), "inliers": {}}
        order = np.argsort(-counts)
        for rank in order[:2]:
            n = int(counts[rank])
            if n < self.min_matches:
                break
            cand = candidates[rank]
            verified = self._verify(kf, cand, res["train_idx"][rank], res["valid"][rank])
            if verified is not None:
                verified.update({"candidate": cand, "n_matches": n})
                return verified
        return None

    def _signature_shortlist(self, kf: KeyFrame, candidates: list[KeyFrame]) -> list[KeyFrame]:
        """Top-``shortlist_size`` candidates by global-signature similarity.
        Signatures are computed once per keyframe (missing ones in one
        batched pass) and scored on the host."""
        missing = [c for c in candidates if c.keyframe_id not in self._sig_table]
        if missing:
            descs = torch.stack([c.get_features(0).desc for c in missing])
            valids = torch.stack([c.get_features(0).valid for c in missing])
            for c, sig in zip(missing, batch_signatures(descs, valids)):
                self._sig_table[c.keyframe_id] = sig
        q = self._sig_table.get(kf.keyframe_id)
        if q is None:
            f_q = kf.get_features(0)
            q = self._sig_table[kf.keyframe_id] = keyframe_signature(f_q.desc, f_q.valid).cpu().numpy()
        table = np.stack([self._sig_table[c.keyframe_id] for c in candidates])
        scores = score_signatures(q, table)  # centered cosine (idf analogue)
        top = np.argsort(-scores)[: self.shortlist_size]
        return [candidates[int(i)] for i in top]

    def _verify(
        self,
        kf: KeyFrame,
        cand: KeyFrame,
        train_idx: torch.Tensor,
        match_ok: torch.Tensor,
        sample_idx: torch.Tensor | None = None,
    ) -> Optional[dict]:
        """Geometric verification: PnP of kf's keypoints against cand's
        landmarks -> corrected T_kf_w2c in the candidate's frame, plus the
        measured relative map scale. ``sample_idx`` (256, 6) replaces the
        generator's minimal sets (the tests feed JAX's draws)."""
        pos, has = cand.point_arrays(0)
        ti = train_idx.cpu().numpy()
        ok = match_ok.cpu().numpy() & has[ti]
        if ok.sum() < self.min_inliers:
            return None
        pts3d = pos[ti]
        f_q = kf.get_features(0)
        dev = f_q.xy.device
        if self._gen is None:
            self._gen = torch.Generator(device=dev).manual_seed(99)
        Kinv = torch.as_tensor(self.camera.Kinv, dtype=torch.float32, device=dev)
        xy_norm = normalize_points(Kinv, f_q.xy)
        pnp = ransac_pnp(
            torch.from_numpy(pts3d).to(dev), xy_norm, torch.from_numpy(ok).to(dev), self._gen,
            n_hyp=256, thresh=3.0 / self.camera.fx,
            sample_idx=None if sample_idx is None else sample_idx.to(dev),
        )
        n_inl = int(pnp["n_inliers"])
        if self.funnel:
            self.funnel["inliers"][cand.keyframe_id] = n_inl
        if not bool(pnp["ok"]) or n_inl < self.min_inliers:
            return None
        T_corrected = pnp["T"].cpu().numpy().astype(np.float64)
        inliers = pnp["inliers"].cpu().numpy()
        s_meas = self._measure_scale(kf, pts3d, inliers, T_corrected)
        return {"T_kf_corrected": T_corrected, "n_inliers": n_inl, "s_meas": s_meas}

    def _measure_scale(
        self, kf: KeyFrame, pts3d: np.ndarray, inliers: np.ndarray, T_corr: np.ndarray
    ) -> Optional[float]:
        """Relative map scale at kf against the candidate: over PnP-inlier
        features of kf that also have their own landmark, the median ratio
        of that landmark's depth through kf's drifted pose to the matched
        candidate landmark's depth through the corrected pose. None if fewer
        than 5 pairs (the caller falls back to the baseline ratio)."""
        T_d = np.asarray(kf.T_w2c, np.float64)
        ratios = []
        for q in np.nonzero(inliers)[0]:
            mp_own = kf.get_map_point(0, int(q))
            if mp_own is None or mp_own.is_bad:
                continue
            z_own = (T_d[:3, :3] @ mp_own.position + T_d[:3, 3])[2]
            z_cand = (T_corr[:3, :3] @ pts3d[q] + T_corr[:3, 3])[2]
            if z_own > 1e-6 and z_cand > 1e-6:
                ratios.append(z_own / z_cand)
        if len(ratios) >= 5:
            return float(np.clip(np.median(ratios), 0.2, 5.0))
        return None

    # -- closure -----------------------------------------------------------
    def _covisibility_edges(
        self,
        kfs: list[KeyFrame],
        min_shared: int = 15,
        max_weight_at: int = 50,
        max_span: int = 10,
    ) -> list[tuple[int, int, float]]:
        """Non-sequential covisibility pairs (row indices) weighted by shared
        landmark count, discounted by 1/sqrt(span), within ``max_span``
        keyframes: a covisibility edge measures the current (drifted)
        relative pose at scale 1, which is trustworthy only between
        temporally near keyframes."""
        row_of = {k.keyframe_id: r for r, k in enumerate(kfs)}
        counts: dict[tuple[int, int], int] = {}
        for mp in self.map.get_map_points():
            if mp.is_bad:
                continue
            rows = sorted({row_of[k] for k in mp.observations.get_keyframe_ids() if k in row_of})
            for a in range(len(rows)):
                for b in range(a + 1, len(rows)):
                    if rows[b] - rows[a] > max_span:
                        continue
                    key = (rows[a], rows[b])
                    counts[key] = counts.get(key, 0) + 1
        return [
            (i, j, min(1.0, c / max_weight_at) / float(np.sqrt(j - i)))
            for (i, j), c in counts.items()
            if c >= min_shared and j - i > 1
        ]

    def close(self, kf: KeyFrame, detection: dict, use_sim3: bool = True) -> dict:
        """Apply a verified loop: Sim(3) (or SE(3)) essential-graph
        optimization over all keyframes, then landmark correction: a
        landmark anchored at keyframe r (its first observer) is taken to r's
        old camera frame, divided by r's node scale and mapped out through
        r's corrected pose (reprojection-exact at the anchor view)."""
        kfs = self.map.get_keyframes()
        idx = {k.keyframe_id: i for i, k in enumerate(kfs)}
        i = idx[kf.keyframe_id]
        j = idx[detection["candidate"].keyframe_id]
        T_i_corr = detection["T_kf_corrected"]
        T_j = kfs[j].T_w2c
        T_meas = T_i_corr @ np.linalg.inv(T_j)
        poses = np.stack([k.T_w2c for k in kfs]).astype(np.float32)
        device = kf.get_features(0).xy.device if kf.get_features(0) is not None else None

        s_meas = detection.get("s_meas")
        if s_meas is None:
            # Drifted-vs-corrected baseline ratio, only where the corrected
            # baseline is appreciable (a revisit at the candidate viewpoint
            # measures drift distance there, not scale: default to 1).
            def center(T):
                return -T[:3, :3].T @ T[:3, 3]

            centers = np.stack([center(k.T_w2c) for k in kfs])
            med_baseline = float(
                np.median(np.linalg.norm(np.diff(centers, axis=0), axis=-1))
            ) if len(kfs) > 1 else 0.0
            d_drift = float(np.linalg.norm(center(kfs[i].T_w2c) - center(T_j)))
            d_corr = float(np.linalg.norm(center(T_i_corr) - center(T_j)))
            if d_corr > max(0.5 * med_baseline, 1e-6):
                s_meas = float(np.clip(d_drift / d_corr, 0.2, 5.0))
            else:
                s_meas = 1.0

        covis = self._covisibility_edges(kfs)
        if use_sim3:
            graph = build_sim3_graph(poses, loop_edges=[(i, j, T_meas, s_meas)], covis_edges=covis, device=device)
            T_opt, scales, info = optimize_sim3_graph(graph, n_iter=15)
            scales = scales.cpu().numpy().astype(np.float64)
        else:
            graph = build_sequential_graph(
                poses,
                loop_edges=[(i, j, T_meas)] + [
                    # Covisibility edges keep their own (discounted) weights.
                    (a, b, poses[a] @ np.linalg.inv(poses[b]), wt)
                    for a, b, wt in covis
                ],
                device=device,
            )
            T_opt, info = optimize_pose_graph(graph, n_iter=15)
            scales = np.ones(len(kfs))
        T_opt = T_opt.cpu().numpy().astype(np.float64)
        cost = float(info["cost"])

        # Landmark correction (anchor = first observing keyframe).
        kf_row = {k.keyframe_id: r for r, k in enumerate(kfs)}
        T_old = poses.astype(np.float64)
        corrected = 0
        for mp in self.map.get_map_points():
            if mp.is_bad:
                continue
            rows = [kf_row[k] for k in mp.observations.get_keyframe_ids() if k in kf_row]
            if not rows:
                continue
            r = min(rows)
            x_cam = T_old[r, :3, :3] @ mp.position + T_old[r, :3, 3]
            x_cam /= scales[r]
            X_new = T_opt[r, :3, :3].T @ (x_cam - T_opt[r, :3, 3])
            mp.update_position(X_new)
            corrected += 1

        for k, kfr in enumerate(kfs):
            kfr.update_pose(T_opt[k])
        self.closed_loops.append((kf.keyframe_id, detection["candidate"].keyframe_id))
        self._last_closed_kf_id = kf.keyframe_id
        self.logger.info(
            "closed loop %d -> %d (%d inliers, s_meas %.3f, %d covis edges); pose-graph cost %.5f",
            kf.keyframe_id, detection["candidate"].keyframe_id,
            detection["n_inliers"], s_meas, len(covis), cost,
        )
        result = {
            "pose_graph_cost": cost,
            "loop": (i, j),
            "scale_meas": s_meas,
            "covis_edges": len(covis),
            "landmarks_corrected": corrected,
        }
        if self.optimizer is not None:
            result["global_ba"] = self.map.optimize_global(self.optimizer)
        return result

    def process_keyframe(self, kf: KeyFrame) -> Optional[dict]:
        if kf.keyframe_id - self._last_closed_kf_id < self.cooldown:
            return None
        det = self.detect(kf)
        if det is None:
            return None
        return self.close(kf, det)
