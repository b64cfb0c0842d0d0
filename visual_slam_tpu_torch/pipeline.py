"""Fused mono tracking step (port of ``visual_slam_tpu.pipeline``).

One call per frame runs detect (pyramid, FAST, kernel K1, steered BRIEF)
-> match against the reference keyframe (kernel K2) -> projection-guided
match against the landmark arena (kernel K3) -> RANSAC-PnP with a
Gauss-Newton fallback from the constant-velocity prediction -> motion
model update. The state lives on the device and the step never reads a
value back to the host: every decision is a ``torch.where``.

Stereo and RGB-D steps are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from .ops import orb as orb_ops
from .ops.detector import Features, detect_and_describe
from .ops.guided_matching import guided_match
from .ops.lie import make_T, rotation_angle, se3_inverse
from .ops.matching import match_descriptors
from .ops.pnp import _reproj_err2, ransac_pnp, refine_pose_gn
from .ops.projection import normalize_points


class TrackState(NamedTuple):
    """Device-resident tracking state. ``gen`` draws the RANSAC samples and
    is advanced in place by every step (the JAX state's ``key``)."""

    ref_feats: Features  # reference keyframe feature block
    ref_landmarks: torch.Tensor  # (K, 3) landmark per reference keypoint slot
    ref_has_landmark: torch.Tensor  # (K,) bool
    T_w2c: torch.Tensor  # (4, 4) current pose
    T_rel: torch.Tensor  # (4, 4) constant-velocity motion model
    gen: torch.Generator
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
    threshold ``thresh`` in normalized units."""

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
        self.to(device)

    def detect(self, img: torch.Tensor) -> Features:
        return detect_and_describe(
            img, self.sampling, self.moment_w,
            num_features=self.num_features, threshold=self.fast_threshold,
            n_levels=self.n_levels, scale=self.scale, grid=self.grid,
        )

    def forward(self, state: TrackState, img: torch.Tensor) -> tuple[TrackState, TrackOutput]:
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
        pair_valid = match["valid"] & state.ref_has_landmark[ti]
        pts3d = state.ref_landmarks[ti]
        xy_norm = normalize_points(self.Kinv, feats.xy)
        T_pred = state.T_rel @ state.T_w2c
        n = self.num_features
        if self.local_map:
            # Rotation-adaptive search window (see the JAX step): widen by
            # the pixel scale of the motion model's per-frame rotation.
            r0 = self.guided_radius_px
            rot = rotation_angle(state.T_rel[:3, :3])
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
            pts3d = torch.where(guided_valid[:, None], g["pts3d"], pts3d)
            pair_valid = guided_valid | pair_valid
        else:
            guided_idx = torch.zeros(n, dtype=torch.int64, device=img.device)
            guided_valid = torch.zeros(n, dtype=torch.bool, device=img.device)
        with record_function("ransac_pnp"):
            res = ransac_pnp(
                pts3d, xy_norm, pair_valid, state.gen, n_hyp=self.pnp_hypotheses, thresh=self.thresh
            )
        with record_function("fallback_gn"):
            # Motion-model fallback: robust GN from the predicted pose.
            R_f, t_f = refine_pose_gn(
                T_pred[:3, :3], T_pred[:3, 3], pts3d, xy_norm, pair_valid.to(torch.float32),
                iters=8, huber=self.thresh,
            )
        inl_f = (_reproj_err2(R_f, t_f, pts3d, xy_norm) < self.thresh * self.thresh) & pair_valid
        use_fallback = inl_f.sum() > res["n_inliers"]
        R = torch.where(use_fallback, R_f, res["R"])
        t = torch.where(use_fallback, t_f, res["t"])
        inliers = torch.where(use_fallback, inl_f, res["inliers"])
        n_inl = inliers.sum()
        ok = n_inl >= 6
        T_new = torch.where(ok, make_T(R, t), T_pred)
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
            kp_z=torch.zeros(n, dtype=torch.float32, device=img.device),
            kp_z_valid=torch.zeros(n, dtype=torch.bool, device=img.device),
        )
        return state._replace(T_w2c=T_new, T_rel=T_rel), out


def make_track_step(K, stereo: bool = False, **kwargs) -> TrackStep:
    """Build the tracking step; keyword arguments as ``TrackStep``."""
    if stereo:
        raise NotImplementedError("the stereo tracking step is not ported yet")
    return TrackStep(K, **kwargs)


def _stack(items):
    if isinstance(items[0], tuple):
        return type(items[0])(*[_stack([it[i] for it in items]) for i in range(len(items[0]))])
    return torch.stack(items, dim=0)


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
