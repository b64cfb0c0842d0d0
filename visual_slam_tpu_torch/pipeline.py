"""Fused mono tracking step (port of ``visual_slam_tpu.pipeline``).

One call per frame runs detect (pyramid, FAST, kernel K1, steered BRIEF)
-> match against the reference keyframe (kernel K2) -> projection-guided
match against the landmark arena (kernel K3) -> RANSAC-PnP with a
Gauss-Newton fallback from the constant-velocity prediction -> motion
model update. The state lives on the device and the step never reads a
value back to the host: every decision is a ``torch.where``.

The same step tracks B sequences at once (``parallel.multiseq``, the JAX
package's ``vmap`` of the step): given (B, H, W) frames and a state whose
leaves are stacked on a leading B (``stack_track_states``, with B
generators), every stage runs batched and each kernel launches once for
all B; ``split_track_outputs`` gives back the B ``TrackOutput``s.

``make_track_chunk`` runs the step over a chunk of frames with a fixed
reference; ``make_track_chunk_promote`` also promotes keyframes inside the
chunk on the device (inheriting and triangulating the new reference
block), and ``make_compact_chunk`` gathers what the host needs at the
chunk boundary into one small structure.

``make_frame_step`` builds the host facade's one-call frame step, for
monocular, stereo (a (2, H, W) pair detected as one batch) and RGB-D
frames. The stereo ``TrackStep`` of ``CompiledSLAM`` is not ported yet:
``make_track_step(stereo=True)`` and ``make_track_chunk_promote(stereo=True)``
raise (ROADMAP M9b).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .ops import orb as orb_ops
from .ops.batch import take_rows
from .ops.detector import Features, detect_and_describe
from .ops.guided_matching import guided_match
from .ops.lie import make_T, rotation_angle, se3_inverse
from .ops.matching import match_descriptors
from .ops.pnp import _reproj_err2, ransac_pnp, refine_pose_gn
from .ops.projection import normalize_points
from .ops.stereo import measure_keypoint_depths
from .ops.triangulation import triangulate_gated
from .utils.device import default_device
from .utils.tree import to_device, tree_map


class TrackState(NamedTuple):
    """Device-resident tracking state. ``gen`` draws the RANSAC samples and
    is advanced in place by every step (the JAX state's ``key``). A batched
    state stacks every tensor leaf on a leading B and holds a tuple of B
    generators, one per sequence."""

    ref_feats: Features  # reference keyframe feature block
    ref_landmarks: torch.Tensor  # (K, 3) landmark per reference keypoint slot
    ref_has_landmark: torch.Tensor  # (K,) bool
    T_w2c: torch.Tensor  # (4, 4) current pose
    T_rel: torch.Tensor  # (4, 4) constant-velocity motion model
    gen: torch.Generator | tuple[torch.Generator, ...]
    lm_pos: torch.Tensor | None = None  # (M, 3) local-map arena
    lm_desc: torch.Tensor | None = None  # (M, 8) int32 words
    lm_valid: torch.Tensor | None = None  # (M,) bool


class TrackOutput(NamedTuple):
    T_w2c: torch.Tensor
    n_inliers: torch.Tensor
    n_matches: torch.Tensor
    features: Features
    match_train_idx: torch.Tensor
    match_valid: torch.Tensor
    pnp_inliers: torch.Tensor
    guided_idx: torch.Tensor
    guided_valid: torch.Tensor
    kp_z: torch.Tensor
    kp_z_valid: torch.Tensor


class TrackStep(nn.Module):
    """The per-frame tracking step for one camera and configuration.

    Buffers: the intrinsics ``K`` and ``Kinv``, the (961, 15360) rotated-BRIEF
    ``sampling`` matrix, the (961, 2) ``moment_w`` weights and the inlier
    threshold ``thresh`` in normalized units, all on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        K,
        num_features: int = 2000,
        fast_threshold: float = 20.0,
        n_levels: int = 4,
        scale: float = 1.2,
        grid: int = 8,
        ratio: float = 0.75,
        pnp_hypotheses: int = 128,
        pnp_threshold_px: float = 3.0,
        local_map: bool = False,
        width: float | None = None,
        height: float | None = None,
        guided_radius_px: float = 25.0,
        guided_ratio: float = 0.8,
        device=None,
    ):
        super().__init__()
        K32 = torch.as_tensor(np.asarray(K, np.float32))
        self.register_buffer("K", K32)
        self.register_buffer("Kinv", torch.linalg.inv(K32))
        self.register_buffer("thresh", torch.tensor(pnp_threshold_px, dtype=torch.float32) / K32[0, 0])
        self.register_buffer("sampling", torch.tensor(orb_ops.sampling_matrix_np()))
        self.register_buffer("moment_w", torch.tensor(orb_ops.MOMENT_W_NP))
        self.num_features = num_features
        self.fast_threshold = fast_threshold
        self.n_levels = n_levels
        self.scale = scale
        self.grid = grid
        self.ratio = ratio
        self.pnp_hypotheses = pnp_hypotheses
        self.local_map = local_map
        self.width = float(width) if width is not None else float(2.0 * K32[0, 2])
        self.height = float(height) if height is not None else float(2.0 * K32[1, 2])
        self.guided_radius_px = guided_radius_px
        self.guided_ratio = guided_ratio
        self.to(default_device(device))

    def detect(self, img: torch.Tensor) -> Features:
        return detect_and_describe(
            img, self.sampling, self.moment_w,
            num_features=self.num_features, threshold=self.fast_threshold,
            n_levels=self.n_levels, scale=self.scale, grid=self.grid,
        )

    def solve_pose(self, pts3d, xy_norm, pair_valid, T_pred, gen, sample_idx=None, depth=None):
        """RANSAC-PnP over the 3D-2D pairs, and a robust Gauss-Newton from the
        predicted pose that wins where it holds more inliers. Returns
        (T_w2c (4, 4), inliers (N,)), on the device; with a leading B on
        every input (and B generators) each output carries it. ``depth``
        (kp_z (N,), kp_z_valid (N,), baseline) adds the depth residual to
        both solves (``ransac_pnp_depth``, ``refine_pose_gn_depth``)."""
        d_ransac = d_gn = {}
        if depth is not None:
            z, z_ok, b = depth
            d_ransac = {"z_meas": z, "z_valid": z_ok, "baseline": b}
            d_gn = {"z_meas": z, "w_z": z_ok.to(torch.float32), "baseline": b}
        with record_function("ransac_pnp"):
            res = ransac_pnp(pts3d, xy_norm, pair_valid, gen, n_hyp=self.pnp_hypotheses, thresh=self.thresh,
                             sample_idx=sample_idx, **d_ransac)
        with record_function("fallback_gn"):
            R_f, t_f = refine_pose_gn(T_pred[..., :3, :3], T_pred[..., :3, 3], pts3d, xy_norm,
                                      pair_valid.to(torch.float32), iters=8, huber=self.thresh, **d_gn)
        inl_f = (_reproj_err2(R_f, t_f, pts3d, xy_norm) < self.thresh * self.thresh) & pair_valid
        use_fallback = (inl_f.sum(-1) > res["n_inliers"])[..., None]
        T = make_T(torch.where(use_fallback[..., None], R_f, res["R"]), torch.where(use_fallback, t_f, res["t"]))
        return T, torch.where(use_fallback, inl_f, res["inliers"])

    def forward(self, state: TrackState, img: torch.Tensor) -> tuple[TrackState, TrackOutput]:
        """One frame (H, W), or one frame of each of B sequences (B, H, W)
        against a batched state."""
        nb = img.dim() - 2  # leading batch dimensions: 0, or 1 for B sequences
        # record_function spans name the stages in a torch.profiler trace
        # (about a microsecond each when no profiler runs).
        with record_function("detect"):
            feats = self.detect(img)
        with record_function("match"):
            ref = state.ref_feats
            match = match_descriptors(
                feats.desc, ref.desc, feats.valid, ref.valid, feats.angle, ref.angle,
                ratio=self.ratio, cross_check=True, use_orientation=True,
            )
        ti = match["train_idx"]
        pair_valid = match["valid"] & take_rows(state.ref_has_landmark, ti, nb)
        pts3d = take_rows(state.ref_landmarks, ti, nb)
        xy_norm = normalize_points(self.Kinv, feats.xy)
        T_pred = state.T_rel @ state.T_w2c
        if self.local_map:
            # Rotation-adaptive search window (see the JAX step): widen by
            # the pixel scale of the motion model's per-frame rotation.
            r0 = self.guided_radius_px
            rot = rotation_angle(state.T_rel[..., :3, :3])
            radius = torch.clamp(r0 + self.K[0, 0] * rot, r0, 4.0 * r0)
            with record_function("guided_match"):
                g = guided_match(
                    state.lm_pos, state.lm_desc, state.lm_valid, T_pred, self.K,
                    feats.xy, feats.desc, feats.valid, self.width, self.height,
                    radius_px=radius, ratio=self.guided_ratio,
                )
            guided_idx = g["lm_idx"]
            # The cross-checked reference match wins where present; guided
            # pairs fill the keypoints it could not serve.
            guided_valid = g["valid"] & ~pair_valid
            pts3d = torch.where(guided_valid[..., None], g["pts3d"], pts3d)
            pair_valid = guided_valid | pair_valid
        else:
            guided_idx = torch.zeros(feats.valid.shape, dtype=torch.int64, device=img.device)
            guided_valid = torch.zeros(feats.valid.shape, dtype=torch.bool, device=img.device)
        T, inliers = self.solve_pose(pts3d, xy_norm, pair_valid, T_pred, state.gen)
        n_inl = inliers.sum(-1)
        ok = (n_inl >= 6)[..., None, None]
        T_new = torch.where(ok, T, T_pred)
        T_rel = torch.where(ok, T_new @ se3_inverse(state.T_w2c), state.T_rel)
        out = TrackOutput(
            T_w2c=T_new,
            n_inliers=n_inl,
            n_matches=match["n_matches"],
            features=feats,
            match_train_idx=ti,
            match_valid=match["valid"],
            pnp_inliers=inliers,
            guided_idx=guided_idx,
            guided_valid=guided_valid,
            kp_z=torch.zeros(feats.valid.shape, dtype=torch.float32, device=img.device),
            kp_z_valid=torch.zeros(feats.valid.shape, dtype=torch.bool, device=img.device),
        )
        return state._replace(T_w2c=T_new, T_rel=T_rel), out


def make_track_step(K, stereo: bool = False, **kwargs) -> TrackStep:
    """Build the tracking step; keyword arguments as ``TrackStep``."""
    if stereo:
        raise NotImplementedError("the stereo tracking step is not ported yet: ROADMAP M9b")
    return TrackStep(K, **kwargs)


class FrameStep:
    """The host facade's fused frame step (``trackingalgorithm.FusedMonoTracking``):
    detect (K1) -> projection-guided association against the given landmark
    block (K3) -> RANSAC-PnP, with a Gauss-Newton fallback from the given
    predicted pose, on ``TrackStep``'s buffers and settings. Unlike the
    step it takes the landmark block, the predicted pose and the generator
    explicitly, so the host ``Tracking`` state machine drives it; keypoints
    of a distorted camera are undistorted inside.

    ``stereo``: the image is a (2, H, W) left/right pair, detected as one
    batch (one K1 launch); each left keypoint's depth comes from the
    row-gated right match. ``rgbd``: the image is a (2, H, W) stack of
    (gray, depth map); each keypoint's depth is the map's pixel. Both go
    through ``ops.stereo.measure_keypoint_depths``, depth window included.
    Either solves the depth-aware PnP with ``baseline`` (the rig's, or
    RGB-D's virtual one) and returns ``features_right`` (stereo), ``kp_z``
    and ``kp_z_valid`` besides."""

    def __init__(self, step: TrackStep, dist=None, stereo: bool = False, rgbd: bool = False, baseline: float = 0.0,
                 stereo_row_tolerance: float = 2.0, min_depth: float = 0.1, max_depth: float = 50.0,
                 depth_scale: float = 1.0):
        if (stereo or rgbd) and baseline <= 0:
            raise ValueError("stereo and RGB-D frame steps need a positive (virtual) baseline")
        self.step = step
        self.dist = None if dist is None else torch.as_tensor(np.asarray(dist, np.float32)).to(step.K.device)
        self.stereo, self.rgbd, self.baseline = stereo, rgbd, baseline
        self.bf = baseline * float(step.K[0, 0])
        self.depth_settings = {"row_tolerance": stereo_row_tolerance, "depth_scale": depth_scale,
                               "min_depth": min_depth, "max_depth": max_depth}

    def _detect(self, img) -> Features:
        from .ops.projection import undistort_pixels

        s = self.step
        feats = s.detect(img)
        if self.dist is not None:
            feats = feats._replace(xy=undistort_pixels(s.K, s.Kinv, self.dist, feats.xy))
        return feats

    def __call__(self, img, lm_pos, lm_desc, lm_valid, T_pred, gen, sample_idx=None) -> dict:
        s = self.step
        out, depth = {}, None
        if self.stereo:
            pair = self._detect(img)
            feats, feats_r = (Features(*[a[b] for a in pair]) for b in (0, 1))
            kp_z, kp_z_valid = measure_keypoint_depths(feats, feats_r, self.bf, **self.depth_settings)
            out["features_right"] = feats_r
        elif self.rgbd:
            feats = self._detect(img[0])
            kp_z, kp_z_valid = measure_keypoint_depths(feats, img[1], **self.depth_settings)
        else:
            feats = self._detect(img)
        if self.stereo or self.rgbd:
            depth = (kp_z, kp_z_valid, self.baseline)
            out.update(kp_z=kp_z, kp_z_valid=kp_z_valid)
        g = guided_match(lm_pos, lm_desc, lm_valid, T_pred, s.K, feats.xy, feats.desc, feats.valid, s.width,
                         s.height, radius_px=s.guided_radius_px, ratio=s.guided_ratio)
        pair_valid = g["valid"]
        T, inliers = s.solve_pose(g["pts3d"], normalize_points(s.Kinv, feats.xy), pair_valid, T_pred, gen,
                                  sample_idx=sample_idx, depth=depth)
        n_inl = inliers.sum()
        out.update(features=feats, T_w2c=T, n_inliers=n_inl, pair_valid=pair_valid, lm_idx=g["lm_idx"],
                   pnp_inliers=inliers, ok=n_inl >= 6)
        return out


def make_frame_step(K, width: float, height: float, num_features: int = 2000, fast_threshold: float = 20.0,
                    n_levels: int = 4, scale: float = 1.2, grid: int = 8, pnp_hypotheses: int = 128,
                    pnp_threshold_px: float = 3.0, guided_radius_px: float = 25.0, guided_ratio: float = 0.8,
                    dist=None, stereo: bool = False, rgbd: bool = False, baseline: float = 0.0,
                    stereo_row_tolerance: float = 2.0, min_depth: float = 0.1, max_depth: float = 50.0,
                    depth_scale: float = 1.0, device=None) -> FrameStep:
    """The fused host-facade frame step on ``device`` (the card unless the
    caller asks for the CPU); ``stereo`` / ``rgbd`` and their settings as
    ``FrameStep``."""
    step = TrackStep(K, num_features=num_features, fast_threshold=fast_threshold, n_levels=n_levels, scale=scale,
                     grid=grid, pnp_hypotheses=pnp_hypotheses, pnp_threshold_px=pnp_threshold_px, width=width,
                     height=height, guided_radius_px=guided_radius_px, guided_ratio=guided_ratio, device=device)
    return FrameStep(step, dist=dist, stereo=stereo, rgbd=rgbd, baseline=baseline,
                     stereo_row_tolerance=stereo_row_tolerance, min_depth=min_depth, max_depth=max_depth,
                     depth_scale=depth_scale)


def _stack(items):
    if isinstance(items[0], tuple):
        return type(items[0])(*[_stack([it[i] for it in items]) for i in range(len(items[0]))])
    return torch.stack(items, dim=0)


def stack_track_states(states) -> TrackState:
    """B single-sequence states -> one batched state: every tensor leaf
    stacked on a leading B, the B generators kept as a tuple (each sequence
    goes on drawing from its own)."""
    return TrackState(*[
        tuple(leaves) if name == "gen" else None if leaves[0] is None else _stack(leaves)
        for name, leaves in zip(TrackState._fields, zip(*states))
    ])


def split_track_outputs(out: TrackOutput) -> list[TrackOutput]:
    """One batched ``TrackOutput`` -> the B single-sequence outputs (views)."""
    return [tree_map(lambda x: x[b], out) for b in range(out.T_w2c.shape[0])]


def make_track_chunk(track_step: TrackStep):
    """Multi-frame tracking: ``chunk(state, imgs (C, H, W)) -> (state, outs)``
    runs the step over the chunk in order, with every ``TrackOutput`` leaf
    stacked along a leading C axis."""

    def chunk(state: TrackState, imgs: torch.Tensor) -> tuple[TrackState, TrackOutput]:
        outs = []
        for img in imgs:
            state, out = track_step(state, img)
            outs.append(out)
        return state, _stack(outs)

    return chunk


class PromoteRecord(NamedTuple):
    """Per-frame record of an in-chunk keyframe promotion. ``ref_pos`` and
    ``ref_has`` are the new reference block per current-frame keypoint slot
    (zeros where the frame did not promote); ``ref_tri`` marks the slots
    the device triangulated fresh, the only ones that may mint new
    landmarks on the host."""

    promoted: torch.Tensor  # () bool
    ref_pos: torch.Tensor  # (K, 3)
    ref_has: torch.Tensor  # (K,) bool
    ref_tri: torch.Tensor  # (K,) bool, subset of ref_has


def promote_block(s: TrackState, out: TrackOutput, T_ref: torch.Tensor, Kinv: torch.Tensor, min_depth,
                  max_depth, min_parallax_rad, reproj_thresh_n):
    """The new reference block from the current frame's associations:
    landmarks inherited through the guided arena match (which wins) or the
    reference-block match, PnP inliers only, and fresh ones triangulated
    against the old reference (``triangulate_gated``) for matched keypoints
    without a landmark. Returns (state with the new block, ref_pos (K, 3),
    ref_has (K,), ref_tri (K,))."""
    ti = out.match_train_idx
    inl = out.pnp_inliers
    g_ok = out.guided_valid & inl
    has_ref = s.ref_has_landmark[ti]
    inherit_ref = out.match_valid & inl & has_ref & ~g_ok
    pos = s.ref_landmarks[ti]
    if s.lm_pos is not None:
        pos = torch.where(g_ok[:, None], s.lm_pos[out.guided_idx], pos)
    has = g_ok | inherit_ref
    tri_cand = out.match_valid & ~has_ref & ~has
    pts_tri, tri_good = triangulate_gated(Kinv, T_ref, out.T_w2c, s.ref_feats.xy[ti], out.features.xy,
                                          min_depth, max_depth, min_parallax_rad, reproj_thresh_n)
    tri_ok = tri_cand & tri_good
    pos = torch.where(tri_ok[:, None], pts_tri, pos)
    has = has | tri_ok
    return s._replace(ref_feats=out.features, ref_landmarks=pos, ref_has_landmark=has), pos, has, tri_ok


class TrackChunkPromote:
    """Chunked tracking with in-chunk keyframe promotion:
    ``chunk(state, fsr, T_ref, imgs (C, H, W), n_valid=None) -> (state,
    fsr, T_ref, outs, recs)`` with every leaf of ``outs`` (TrackOutput) and
    ``recs`` (PromoteRecord) stacked along a leading C axis. ``fsr`` counts
    frames since the reference and ``T_ref`` is the reference pose; the
    host seeds both at every boundary.

    Every frame evaluates the keyframe gates (interval, match decay,
    rotation, translation) on the device and swaps the reference to itself
    when they fire and it tracked at least ``min_inliers``. The JAX version
    branches with ``lax.cond``; here ``promote_block`` runs every frame and
    ``torch.where`` selects, so no frame reads a value back to the host.
    Frames at or past ``n_valid`` (a flush pads the chunk with copies of
    its last frame) never promote."""

    def __init__(self, track_step: TrackStep, K, min_inliers: int = 15, keyframe_interval: int = 4,
                 kf_min_matches: int = 60, kf_min_rotation_deg: float = 10.0, kf_min_translation: float = 1.0,
                 min_depth: float = 0.1, max_depth: float = 1e6, min_parallax_deg: float = 0.5,
                 pnp_threshold_px: float = 3.0):
        self.step = track_step
        self.min_inliers = min_inliers
        self.keyframe_interval = keyframe_interval
        self.kf_min_matches = kf_min_matches
        self.kf_min_translation = kf_min_translation
        K = np.asarray(K, np.float32)
        dev = track_step.K.device

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        self.Kinv = torch.linalg.inv(torch.from_numpy(K).to(dev))
        self.rot_thresh = f32(np.deg2rad(kf_min_rotation_deg))
        self.gates = (f32(min_depth), f32(max_depth), f32(np.deg2rad(min_parallax_deg)),
                      f32(pnp_threshold_px / K[0, 0]))

    def __call__(self, state: TrackState, fsr, T_ref, imgs: torch.Tensor, n_valid: int | None = None):
        dev = state.T_w2c.device
        n_valid = imgs.shape[0] if n_valid is None else int(n_valid)
        fsr = torch.full((), int(fsr), dtype=torch.int32, device=dev) if not torch.is_tensor(fsr) else fsr
        T_ref = T_ref if torch.is_tensor(T_ref) else to_device(np.asarray(T_ref, np.float32), dev)
        outs, recs = [], []
        for i, img in enumerate(imgs):
            state, out = self.step(state, img)
            fsr = fsr + 1
            if i >= n_valid:
                no = torch.zeros_like(out.pnp_inliers)
                outs.append(out)
                recs.append(PromoteRecord(no[0], torch.zeros_like(state.ref_landmarks), no, no))
                continue
            R_cur, t_cur = out.T_w2c[:3, :3], out.T_w2c[:3, 3]
            R_ref, t_ref = T_ref[:3, :3], T_ref[:3, 3]
            gap = torch.linalg.vector_norm(R_ref.T @ t_ref - R_cur.T @ t_cur)  # |C_cur - C_ref|
            trigger = (
                (fsr > self.keyframe_interval)
                | (out.n_inliers < self.kf_min_matches)
                | (rotation_angle(R_cur @ R_ref.T) > self.rot_thresh)
                | (gap > self.kf_min_translation)
            )
            promote = (out.n_inliers >= self.min_inliers) & trigger
            with record_function("promote_block"):
                s2, pos, has, tri = promote_block(state, out, T_ref, self.Kinv, *self.gates)
            state = state._replace(
                ref_feats=Features(*[torch.where(promote, a, b) for a, b in zip(s2.ref_feats, state.ref_feats)]),
                ref_landmarks=torch.where(promote, s2.ref_landmarks, state.ref_landmarks),
                ref_has_landmark=torch.where(promote, s2.ref_has_landmark, state.ref_has_landmark),
            )
            fsr = torch.where(promote, 0, fsr)
            T_ref = torch.where(promote, out.T_w2c, T_ref)
            outs.append(out)
            recs.append(PromoteRecord(promote, torch.where(promote, pos, 0.0), has & promote, tri & promote))
        return state, fsr, T_ref, _stack(outs), _stack(recs)


def make_track_chunk_promote(track_step: TrackStep, K, stereo: bool = False, **kwargs) -> TrackChunkPromote:
    """Build the self-promoting chunk; keyword arguments as ``TrackChunkPromote``."""
    if stereo:
        raise NotImplementedError("stereo in-chunk promotion is not ported yet: ROADMAP M9b")
    return TrackChunkPromote(track_step, K, **kwargs)


class CompactChunk(NamedTuple):
    """What the host reads at a self-promoting chunk's boundary: the
    decision scalars of every frame and the per-keypoint blocks of the
    promoted frames only, gathered on the device into P slots (slot s holds
    the s-th promoted frame)."""

    T_w2c: torch.Tensor  # (C, 4, 4)
    n_inliers: torch.Tensor  # (C,)
    n_matches: torch.Tensor  # (C,)
    promoted: torch.Tensor  # (C,)
    n_promoted: torch.Tensor  # () int32; the host checks overflow (> P)
    slot_frame: torch.Tensor  # (P,) int32 frame index within the chunk, C if empty
    feats: Features  # (P, K, ...)
    match_train_idx: torch.Tensor  # (P, K)
    match_valid: torch.Tensor
    pnp_inliers: torch.Tensor
    guided_idx: torch.Tensor
    guided_valid: torch.Tensor
    ref_pos: torch.Tensor  # (P, K, 3)
    ref_has: torch.Tensor
    ref_tri: torch.Tensor
    sig: torch.Tensor  # (P, V) place signatures, or (P, 1) zeros without loop closing


def correction_similarity(T_old, T_new, s: float):
    """The world-frame similarity ``x_new = s R_u x + t_u`` implied by one
    keyframe's pose update T_old -> T_new (both w2c) and the mono-gauge
    scale ``s``: R_u = R_new^T R_old, t_u = R_new^T (s t_old - t_new).
    Host numpy."""
    T_old = np.asarray(T_old, np.float64)
    T_new = np.asarray(T_new, np.float64)
    R_u = T_new[:3, :3].T @ T_old[:3, :3]
    t_u = T_new[:3, :3].T @ (s * T_old[:3, 3] - T_new[:3, 3])
    return R_u, t_u


def apply_correction(state: TrackState, T_ref, R_u, t_u, s):
    """Re-anchor a device tracking state into a corrected world frame:
    landmarks move by x' = s R_u x + t_u, w2c poses by R' = R R_u^T,
    t' = s t - R' t_u (reprojections unchanged), and the motion model's
    translation scales by s. Returns (state, T_ref). Host values upload
    through pinned memory without waiting (a plain copy to the card would
    synchronise)."""
    R_u, t_u, s = to_device(tuple(np.asarray(x, np.float32) for x in (R_u, t_u, s)), state.T_w2c.device)

    def fix_pose(T):
        R = T[:3, :3] @ R_u.T
        return make_T(R, s * T[:3, 3] - R @ t_u)

    def fix_pts(x):
        return x @ (s * R_u).T + t_u

    T_rel = make_T(state.T_rel[:3, :3], state.T_rel[:3, 3] * s)
    new = state._replace(T_w2c=fix_pose(state.T_w2c), T_rel=T_rel, ref_landmarks=fix_pts(state.ref_landmarks))
    if state.lm_pos is not None:
        new = new._replace(lm_pos=fix_pts(state.lm_pos))
    return new, fix_pose(T_ref)


def make_compact_chunk(P: int, with_sig: bool = False):
    """``compact(outs, recs) -> CompactChunk`` on the device. Without
    ``with_sig`` (loop closing off) the signatures are a (P, 1) zero
    placeholder."""
    from .loop_closing.signature import keyframe_signature

    def compact(outs: TrackOutput, recs: PromoteRecord) -> CompactChunk:
        C = outs.T_w2c.shape[0]
        dev = outs.T_w2c.device
        order = torch.where(recs.promoted, torch.arange(C, device=dev), C)
        slots = torch.sort(order).values[:P]  # ascending promoted frame indices
        idx = torch.clamp(slots, max=C - 1)

        def g(a):
            return a[idx]

        feats = Features(*[g(a) for a in outs.features])
        return CompactChunk(
            T_w2c=outs.T_w2c, n_inliers=outs.n_inliers, n_matches=outs.n_matches, promoted=recs.promoted,
            n_promoted=recs.promoted.to(torch.int32).sum(), slot_frame=slots.to(torch.int32), feats=feats,
            match_train_idx=g(outs.match_train_idx), match_valid=g(outs.match_valid),
            pnp_inliers=g(outs.pnp_inliers), guided_idx=g(outs.guided_idx), guided_valid=g(outs.guided_valid),
            ref_pos=g(recs.ref_pos), ref_has=g(recs.ref_has), ref_tri=g(recs.ref_tri),
            sig=(keyframe_signature(feats.desc, feats.valid) if with_sig
                 else torch.zeros((idx.shape[0], 1), dtype=torch.float32, device=dev)),
        )

    return compact


def init_track_state(
    ref_feats: Features,
    ref_landmarks,
    ref_has_landmark,
    T_w2c,
    seed: int = 0,
    local_map_size: int = 0,
    device=None,
) -> TrackState:
    """Initial state around a reference block, on ``device``; an arena of
    ``local_map_size`` invalid slots when the step uses the local map."""
    device = torch.device(device) if device is not None else ref_feats.xy.device
    lm_pos = lm_desc = lm_valid = None
    if local_map_size:
        lm_pos = torch.zeros((local_map_size, 3), dtype=torch.float32, device=device)
        lm_desc = torch.zeros((local_map_size, orb_ops.N_WORDS), dtype=torch.int32, device=device)
        lm_valid = torch.zeros((local_map_size,), dtype=torch.bool, device=device)
    return TrackState(
        ref_feats=Features(*[f.to(device) for f in ref_feats]),
        ref_landmarks=torch.as_tensor(ref_landmarks, dtype=torch.float32).to(device),
        ref_has_landmark=torch.as_tensor(ref_has_landmark, dtype=torch.bool).to(device),
        T_w2c=torch.as_tensor(np.asarray(T_w2c, np.float32)).to(device),
        T_rel=torch.eye(4, dtype=torch.float32, device=device),
        gen=torch.Generator(device=device).manual_seed(seed),
        lm_pos=lm_pos,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
    )


def set_local_map(state: TrackState, lm_pos, lm_desc, lm_valid) -> TrackState:
    """Install or refresh the local-map arena (same capacity as the state's)."""
    device = state.T_w2c.device
    return state._replace(
        lm_pos=torch.as_tensor(lm_pos, dtype=torch.float32).to(device),
        lm_desc=torch.as_tensor(lm_desc, dtype=torch.int32).to(device),
        lm_valid=torch.as_tensor(lm_valid, dtype=torch.bool).to(device),
    )


def swap_reference(state: TrackState, ref_feats: Features, ref_landmarks, ref_has_landmark) -> TrackState:
    """Keyframe boundary: install a new reference block."""
    device = state.T_w2c.device
    return state._replace(
        ref_feats=ref_feats,
        ref_landmarks=torch.as_tensor(ref_landmarks, dtype=torch.float32).to(device),
        ref_has_landmark=torch.as_tensor(ref_has_landmark, dtype=torch.bool).to(device),
    )
