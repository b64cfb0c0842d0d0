"""DoG SIFT: scale-space detection + the GradHist descriptor
(port of ``visual_slam_tpu.ops.sift``), plain PyTorch with fixed shapes.

Per octave: a Gaussian stack by incremental separable blurs, the
difference-of-Gaussians planes, 26-neighbour extrema as one 3x3x3 max and
min pool ('SAME', -inf padded, as ``reduce_window``), dense contrast and
Hessian edge rejection before the selection, the grid top-k of
``fast.top_k_grid``, a closed-form 3-D quadratic refinement from each
keypoint's 3x3x3 cube (the adjugate of ``lie.adjugate3x3`` over the
determinant of ``lie.det3x3``), a 36-bin orientation histogram and the
GradHist descriptor at the keypoint's own scale plane. The JAX package
computes it with XLA, not a Pallas kernel; no kernel of the port runs here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_ops
from . import pyramid as pyr_ops
from .detector import Features, level_quotas
from .floatdesc import gradhist_descriptors, patch_gradients
from .lie import adjugate3x3, det3x3
from .orb import floor_mod

_SIGMA0 = 1.6  # base scale of each octave (Lowe 2004)
_SIGMA_IN = 0.5  # assumed blur of the raw input image
_N_HBINS = 36  # orientation histogram bins (10 deg each)
_P = 32  # descriptor / orientation patch side


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with the radius ceil(3 sigma)."""
    radius = max(int(np.ceil(3.0 * sigma)), 1)
    return pyr_ops.gaussian_blur(img, sigma=sigma, radius=radius)


def _octave_stack(base: torch.Tensor, n_scales: int) -> torch.Tensor:
    """(S+3, H, W) Gaussian images at sigma0 * 2^(i/S) from a base image
    already at sigma0, each blurred from the previous one."""
    k = 2.0 ** (1.0 / n_scales)
    imgs = [base]
    for i in range(1, n_scales + 3):
        sig_prev = _SIGMA0 * k ** (i - 1)
        imgs.append(_blur(imgs[-1], sig_prev * float(np.sqrt(k * k - 1.0))))
    return torch.stack(imgs)


def _gather_cube(dog: torch.Tensor, plane: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(K, 3, 3, 3) DoG neighbourhoods around (plane, y, x): one flat gather,
    the flat indices clamped to the volume as JAX's gather clamps them."""
    P, H, W = dog.shape
    r = torch.arange(-1, 2, device=dog.device)
    off = (r[:, None, None] * (H * W) + r[None, :, None] * W + r[None, None, :]).reshape(-1)
    centre = plane.long() * (H * W) + yx[:, 0].long() * W + yx[:, 1].long()
    idx = torch.clamp(centre[:, None] + off[None, :], 0, P * H * W - 1)
    return dog.reshape(-1)[idx].reshape(-1, 3, 3, 3)


def _extract_patches_stack(stack: torch.Tensor, plane: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) windows of the Gaussian stack at each keypoint's own
    plane, rows y-16 .. y+15 and columns x-16 .. x+15 with edge
    replication; the centre clamped to [0, H] x [0, W] first, as the JAX
    version's ``dynamic_slice`` of the 16-pixel padded volume clamps its
    start."""
    S, H, W = stack.shape
    off = torch.arange(-(_P // 2), _P // 2, device=yx.device)
    rows = (yx[:, 0].long().clamp(0, H)[:, None] + off).clamp(0, H - 1)
    cols = (yx[:, 1].long().clamp(0, W)[:, None] + off).clamp(0, W - 1)
    pl = plane.long().clamp(0, S - 1)
    return stack[pl[:, None, None], rows[:, :, None], cols[:, None, :]]


def _orientation_weights(n_scales: int) -> np.ndarray:
    """(S, 1024) per-plane Gaussian windows for the orientation histogram
    (sigma = 1.5 x the plane's scale, Lowe): the JAX package's numpy code."""
    c = (_P - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(_P), np.arange(_P), indexing="ij")
    r2 = ((ys - c) ** 2 + (xs - c) ** 2).reshape(-1)
    out = np.zeros((n_scales, _P * _P), np.float32)
    for p in range(n_scales):
        sig = 1.5 * _SIGMA0 * 2.0 ** ((p + 1) / n_scales)
        out[p] = np.exp(-r2 / (2.0 * sig * sig))
    return out


def _orientations_hist(patches: torch.Tensor, plane: torch.Tensor, w_plane: torch.Tensor) -> torch.Tensor:
    """Dominant gradient orientation per patch: a window-weighted 36-bin
    histogram (one product with the bins' one-hot, as the JAX version's
    einsum), circular [1, 4, 6, 4, 1] / 16 smoothing, the first peak and a
    parabolic refinement around it."""
    K = patches.shape[0]
    gx, gy = patch_gradients(patches)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(K, -1)
    ang = torch.atan2(gy, gx).reshape(K, -1)
    two_pi = 2.0 * math.pi
    bins = torch.floor(floor_mod(ang, two_pi) / two_pi * _N_HBINS).to(torch.int64).clamp(0, _N_HBINS - 1)
    onehot = (bins[..., None] == torch.arange(_N_HBINS, device=bins.device)).to(mag.dtype)  # (K, 1024, 36)
    hist = torch.bmm((mag * w_plane[plane.long()])[:, None, :], onehot)[:, 0]  # (K, 36)
    hr = torch.cat([hist[:, -2:], hist, hist[:, :2]], dim=1)
    hist = (hr[:, :-4] + 4.0 * hr[:, 1:-3] + 6.0 * hr[:, 2:-2] + 4.0 * hr[:, 3:-1] + hr[:, 4:]) / 16.0
    peak = torch.argmax(hist, dim=1)
    left = hist.gather(1, ((peak - 1) % _N_HBINS)[:, None])[:, 0]
    mid = hist.gather(1, peak[:, None])[:, 0]
    right = hist.gather(1, ((peak + 1) % _N_HBINS)[:, None])[:, 0]
    denom = left - 2.0 * mid + right
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (left - right) / denom, 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    return (peak.to(torch.float32) + 0.5 + frac) * (two_pi / _N_HBINS)


def _refine(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One Newton step of the 3-D quadratic fit on (K, 3, 3, 3) cubes ([p,
    y, x]): the (x, y, s) offset, zero where the Hessian is singular and
    clamped to +-0.6, and the DoG value at it."""
    gx_ = 0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0])
    gy_ = 0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1])
    gs_ = 0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1])
    hxx = c[:, 1, 1, 2] - 2.0 * c[:, 1, 1, 1] + c[:, 1, 1, 0]
    hyy = c[:, 1, 2, 1] - 2.0 * c[:, 1, 1, 1] + c[:, 1, 0, 1]
    hss = c[:, 2, 1, 1] - 2.0 * c[:, 1, 1, 1] + c[:, 0, 1, 1]
    hxy = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    hxs = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    hys = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    Hm = torch.stack([
        torch.stack([hxx, hxy, hxs], -1), torch.stack([hxy, hyy, hys], -1), torch.stack([hxs, hys, hss], -1),
    ], -2)
    g = torch.stack([gx_, gy_, gs_], -1)
    det = det3x3(Hm)
    ok = torch.abs(det) > 1e-12
    Hinv = adjugate3x3(Hm) / torch.where(ok, det, 1.0)[:, None, None]
    off = -torch.einsum("kij,kj->ki", Hinv, g)
    off = torch.clamp(torch.where(ok[:, None], off, 0.0), -0.6, 0.6)
    val = c[:, 1, 1, 1] + 0.5 * torch.einsum("ki,ki->k", g, off)
    return off, val


def detect_and_describe_sift(
    img: torch.Tensor,
    num_features: int = 1000,
    n_octaves: int = 4,
    n_scales: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    grid: int = 8,
    edge_margin: int = 16,
) -> Features:
    """DoG SIFT detect + describe on one (H, W) image in [0, 255]: the
    fixed-capacity ``Features`` block, descriptors as (K, 128) int32 words
    (bitcast f32), on the image's device."""
    H0, W0 = img.shape
    dev = img.device
    base = img.to(torch.float32) / 255.0
    base = _blur(base, float(np.sqrt(max(_SIGMA0**2 - _SIGMA_IN**2, 0.01))))
    n_oct = max(min(n_octaves, int(np.floor(np.log2(min(H0, W0) / 48.0))) + 1), 1)
    quotas = level_quotas(num_features, n_oct, 2.0)
    w_plane = torch.from_numpy(_orientation_weights(n_scales)).to(dev)
    floor_d = 0.5 * contrast_threshold / n_scales  # cv2's contrast gate on [0, 1] images
    r_edge = edge_threshold
    outs = []
    for o in range(n_oct):
        gauss = _octave_stack(base, n_scales)  # (S+3, Hl, Wl)
        dog = gauss[1:] - gauss[:-1]  # (S+2, Hl, Wl)
        Hl, Wl = dog.shape[1:]
        mx = F.max_pool3d(dog[None, None], 3, stride=1, padding=1)[0, 0]
        mn = -F.max_pool3d(-dog[None, None], 3, stride=1, padding=1)[0, 0]
        is_ext = ((dog >= mx) & (dog > floor_d)) | ((dog <= mn) & (dog < -floor_d))
        # Dense Hessian edge rejection, per plane, by central differences.
        dpad = pyr_ops.pad_replicate(dog, 1)
        dxx = dpad[:, 1:-1, 2:] - 2.0 * dog + dpad[:, 1:-1, :-2]
        dyy = dpad[:, 2:, 1:-1] - 2.0 * dog + dpad[:, :-2, 1:-1]
        dxy = 0.25 * (dpad[:, 2:, 2:] - dpad[:, 2:, :-2] - dpad[:, :-2, 2:] + dpad[:, :-2, :-2])
        tr = dxx + dyy
        det2 = dxx * dyy - dxy * dxy
        not_edge = (det2 > 0.0) & (tr * tr * r_edge < (r_edge + 1.0) ** 2 * det2)
        cand = is_ext & not_edge
        # Only the interior planes 1..S are scale-space extrema.
        score_planes = torch.where(cand[1:n_scales + 1], torch.abs(dog[1:n_scales + 1]), 0.0)
        score = score_planes.amax(dim=0)
        plane_rel = torch.argmax(score_planes, dim=0)  # the first maximum, as jnp.argmax
        m = edge_margin if min(Hl, Wl) > 2 * edge_margin + 8 else 4
        score = torch.where(fast_ops.interior_mask(Hl, Wl, m, dev), score, 0.0)
        k_o = quotas[o]
        yx, resp, valid = fast_ops.top_k_grid(score, k_o, grid=grid)
        valid = valid & (resp > 0.0)
        # The grid's padding slots can sit past the image: clamp, as JAX's gather.
        plane_k = plane_rel[yx[:, 0].long().clamp(0, Hl - 1), yx[:, 1].long().clamp(0, Wl - 1)] + 1
        off, val = _refine(_gather_cube(dog, plane_k, yx))
        valid = valid & (torch.abs(val) * n_scales >= contrast_threshold)
        patches = _extract_patches_stack(gauss, plane_k, yx)
        ang = _orientations_hist(patches, plane_k - 1, w_plane)
        desc = gradhist_descriptors(patches, ang).view(torch.int32)
        scale_up = float(2**o)
        sig_kp = _SIGMA0 * 2.0 ** ((plane_k.to(torch.float32) + off[:, 2]) / n_scales)
        xy_full = torch.stack(
            [(yx[:, 1].to(torch.float32) + off[:, 0]) * scale_up, (yx[:, 0].to(torch.float32) + off[:, 1]) * scale_up],
            dim=-1,
        )
        outs.append(Features(
            xy=xy_full, response=torch.abs(val), angle=ang,
            octave=torch.full((k_o,), o, dtype=torch.int32, device=dev),
            size=sig_kp * scale_up * 2.0, desc=desc, valid=valid,
        ))
        if o + 1 < n_oct:
            base = gauss[n_scales][::2, ::2]  # the 2 sigma0 image, decimated
    return Features(*[torch.cat([getattr(o, f) for o in outs]) for f in Features._fields])
