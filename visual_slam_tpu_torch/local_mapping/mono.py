"""Monocular keyframe handler: neighbour matching and new-landmark
triangulation (port of ``visual_slam_tpu.local_mapping.mono``).

The new keyframe is matched against each of the last ``max_neighbors``
keyframes (``FeatureTracker.match``: kernel K2 and the fundamental
filter); a neighbour's landmark is reused on the new keyframe, duplicates
that agree geometrically are fused, and the remaining matches are
triangulated (DLT) with depth and parallax gates, as fixed-shape tensor
ops on the handler's device. One fetch per neighbour brings the match
table and one per triangulation the gated points; the observation
bookkeeping is host-side dict updates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..initializer import _pixel_color
from ..map import KeyFrame, MapPoint
from ..ops import triangulation as tri_ops
from ..ops.projection import normalize_points
from ..utils.tree import to_host
from .base import BaseKeyframeHandler


class MonoKeyframeHandler(BaseKeyframeHandler):
    def process_keyframe(self, kf: KeyFrame) -> dict:
        neighbors = self._find_neighbors(kf)
        stats = {"reused": 0, "triangulated": 0, "neighbors": len(neighbors)}
        for nb in neighbors:
            r = self._match(kf, nb)
            if r is None:
                continue
            reused, tri_pairs = self._process_existing_points(kf, nb, r)
            created = self._triangulate_new_points(kf, nb, r, tri_pairs)
            stats["reused"] += reused
            stats["triangulated"] += created
        self.logger.debug("KF %d: +%d reused, +%d new landmarks from %d neighbors", kf.keyframe_id,
                          stats["reused"], stats["triangulated"], stats["neighbors"])
        return stats

    def _find_neighbors(self, kf: KeyFrame) -> list[KeyFrame]:
        """The last ``max_neighbors`` keyframes other than ``kf``."""
        n = self.config.local_mapping.max_neighbors
        kfs = [k for k in self.map.get_keyframes() if k.keyframe_id != kf.keyframe_id]
        return kfs[-n:]

    def _match(self, kf: KeyFrame, nb: KeyFrame):
        f1 = kf.get_features(0)
        f2 = nb.get_features(0)
        if f1 is None or f2 is None:
            return None
        return self.tracker.match(f1, f2)

    def _process_existing_points(self, kf: KeyFrame, nb: KeyFrame, r):
        """Reuse neighbour landmarks, fuse duplicates that agree to ~10 % of
        their distance from the keyframe, collect the pairs to triangulate.
        Returns (n_reused, [(i_kf, i_nb), ...])."""
        reused = 0
        tri_pairs: list[tuple[int, int]] = []
        ti, ok = to_host((r.train_idx, r.valid))
        for i_kf in np.nonzero(ok)[0]:
            i_nb = int(ti[i_kf])
            mp = nb.get_map_point(0, i_nb)
            mp_kf = kf.get_map_point(0, int(i_kf))
            if mp is not None and not mp.is_bad:
                if mp_kf is None:
                    kf.add_map_point(0, int(i_kf), mp)
                    reused += 1
                elif mp_kf is not mp and not mp_kf.is_bad:
                    d = float(np.linalg.norm(mp.position - mp_kf.position))
                    depth = float(np.linalg.norm(mp.position - kf.camera_center))
                    if d <= 0.1 * max(depth, 1e-6):
                        keep, drop = ((mp, mp_kf) if mp.num_observations() >= mp_kf.num_observations()
                                      else (mp_kf, mp))
                        self.map.fuse_map_points(keep, drop)
            elif mp_kf is None:
                tri_pairs.append((int(i_kf), i_nb))
        return reused, tri_pairs

    def _triangulate_new_points(self, kf: KeyFrame, nb: KeyFrame, r, tri_pairs) -> int:
        """The pair arrays are padded to the keyframe's feature capacity, so
        every call has one shape."""
        if len(tri_pairs) < 2:
            return 0
        lcfg = self.config.local_mapping
        cap = int(r.features1.xy.shape[0])
        n = min(len(tri_pairs), cap)
        idx_kf = np.zeros(cap, np.int64)
        idx_nb = np.zeros(cap, np.int64)
        pair_mask = np.zeros(cap, bool)
        idx_kf[:n] = [p[0] for p in tri_pairs[:n]]
        idx_nb[:n] = [p[1] for p in tri_pairs[:n]]
        pair_mask[:n] = True
        dev = r.features1.xy.device
        Kinv = torch.as_tensor(self.camera.Kinv, dtype=torch.float32).to(dev)
        x_kf = normalize_points(Kinv, r.features1.xy[torch.from_numpy(idx_kf).to(dev)])
        x_nb = normalize_points(Kinv, r.features2.xy[torch.from_numpy(idx_nb).to(dev)])
        T_kf = torch.as_tensor(kf.T_w2c, dtype=torch.float32).to(dev)
        T_nb = torch.as_tensor(nb.T_w2c, dtype=torch.float32).to(dev)
        pts3d, w_ok = tri_ops.triangulate_dlt(tri_ops.projection_from_T(T_nb), tri_ops.projection_from_T(T_kf),
                                              x_nb, x_kf)
        good = w_ok & tri_ops.depth_mask(T_nb, T_kf, pts3d, lcfg.min_depth, lcfg.max_depth)
        good = good & (tri_ops.parallax_angles(T_nb, T_kf, pts3d) >= np.deg2rad(lcfg.min_parallax_deg))
        good_np, pts_np = to_host((good, pts3d))
        good_np = good_np & pair_mask
        img = nb.get_image(0)
        xy_nb = nb.keypoints(0)
        desc_nb = nb.descriptors(0)
        created = 0
        for n in np.nonzero(good_np)[0]:
            i_kf, i_nb = tri_pairs[n]
            mp = MapPoint(pts_np[n], color=_pixel_color(img, xy_nb[i_nb]), descriptor=desc_nb[i_nb])
            nb.add_map_point(0, i_nb, mp)
            kf.add_map_point(0, i_kf, mp)
            self.map.add_map_point(mp)
            created += 1
        return created
