"""GradHist: the 128-d float descriptor of the float families
(port of ``visual_slam_tpu.ops.floatdesc``), plain PyTorch.

A 4x4-cell x 8-orientation-bin gradient histogram: central-difference
patch gradients, orientations soft-binned into 8 bins by clipped cos^3
lobes, spatial pooling into the cell grid as one product with 30
pre-rotated Gaussian-windowed cell-weight matrices (the rBRIEF steering
trick: the keypoint's rotation bin picks its matrix's columns), then
SIFT's normalise -> clip 0.2 -> renormalise. The JAX package computes it
with XLA, not a Pallas kernel; the pooling product is one ``matmul`` here.

Descriptors are stored bitcast into int32 words ((K, 128) words, the
``Features.desc`` block of the float families); the L2 matchers view them
back as f32 (``Tensor.view``, exact both ways).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import orb as orb_ops
from . import pyramid as pyr_ops
from .detector import Features, detect_level, level_quotas

N_CELLS = 4  # 4x4 spatial grid
N_OBINS = 8  # orientation bins
N_ROT = 30  # rotation quantization (rBRIEF's)
DESC_DIM = N_CELLS * N_CELLS * N_OBINS  # 128
_P = 32  # patch side


def _make_cell_weights() -> np.ndarray:
    """(N_ROT, 1024, 16) Gaussian-windowed bilinear cell weights, one per
    rotation bin: pixel (y, x) of the patch contributes to the 4x4 cell grid
    at its position rotated by -theta_b about the patch center (the JAX
    package's numpy code, the same constant bit for bit)."""
    c = (_P - 1) / 2.0
    half = 31 / 2.0  # active patch half-width (pixels beyond 31 get ~0)
    cell_w = 31 / N_CELLS
    sigma = 31 / 2.0
    ys, xs = np.meshgrid(np.arange(_P), np.arange(_P), indexing="ij")
    ys = (ys - c).reshape(-1)
    xs = (xs - c).reshape(-1)
    out = np.zeros((N_ROT, _P * _P, N_CELLS * N_CELLS), np.float32)
    for b in range(N_ROT):
        th = 2.0 * np.pi * b / N_ROT
        co, si = np.cos(-th), np.sin(-th)
        ry = si * xs + co * ys
        rx = co * xs - si * ys
        w_g = np.exp(-(rx**2 + ry**2) / (2 * sigma**2))
        w_g *= (np.abs(rx) <= half) & (np.abs(ry) <= half)
        cy = (ry + half) / cell_w
        cx = (rx + half) / cell_w
        y0 = np.clip(np.floor(cy - 0.5), 0, N_CELLS - 1).astype(int)
        x0 = np.clip(np.floor(cx - 0.5), 0, N_CELLS - 1).astype(int)
        fy = np.clip(cy - 0.5 - y0, 0.0, 1.0)
        fx = np.clip(cx - 0.5 - x0, 0.0, 1.0)
        y1 = np.minimum(y0 + 1, N_CELLS - 1)
        x1 = np.minimum(x0 + 1, N_CELLS - 1)
        idx = np.arange(_P * _P)
        out[b, idx, y0 * N_CELLS + x0] += w_g * (1 - fy) * (1 - fx)
        out[b, idx, y0 * N_CELLS + x1] += w_g * (1 - fy) * fx
        out[b, idx, y1 * N_CELLS + x0] += w_g * fy * (1 - fx)
        out[b, idx, y1 * N_CELLS + x1] += w_g * fy * fx
    return out


@functools.cache
def _cell_weights_np() -> np.ndarray:
    """(1024, N_ROT * 16): the cell weights flattened for one product."""
    w = _make_cell_weights().transpose(1, 0, 2).reshape(_P * _P, N_ROT * N_CELLS * N_CELLS)
    w.setflags(write=False)
    return w


@functools.cache
def _consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flattened cell weights and the orientation bins' cos and sin on
    ``device`` (made once a device)."""
    obin = torch.tensor(2.0 * np.pi * np.arange(N_OBINS) / N_OBINS, dtype=torch.float32)
    return torch.tensor(_cell_weights_np()).to(device), torch.cos(obin).to(device), torch.sin(obin).to(device)


def patch_gradients(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences (K, P, P) -> (gx, gy), zero on the patch's
    first and last column (gx) and row (gy)."""
    gx = torch.zeros_like(p)
    gy = torch.zeros_like(p)
    gx[:, :, 1:-1] = (p[:, :, 2:] - p[:, :, :-2]) * 0.5
    gy[:, 1:-1, :] = (p[:, 2:, :] - p[:, :-2, :]) * 0.5
    return gx, gy


def gradhist_descriptors(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) patches + (K,) keypoint angles -> (K, 128) f32
    L2-normalised descriptors, ordered (cell, orientation bin)."""
    K = patches.shape[0]
    cell_w, cos_o, sin_o = _consts(patches.device)
    gx, gy = patch_gradients(patches)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(K, -1)  # (K, 1024)
    gang = torch.atan2(gy, gx).reshape(K, -1) - angles[:, None]
    ca, sa = torch.cos(gang), torch.sin(gang)
    lobes = torch.clamp(ca[..., None] * cos_o + sa[..., None] * sin_o, min=0.0) ** 3  # (K, 1024, 8)
    contrib = mag[..., None] * lobes
    # Pooling for all 30 rotation bins at once: (K, 8, 1024) @ (1024, 30 * 16).
    pooled = (contrib.transpose(1, 2) @ cell_w).reshape(K, N_OBINS, N_ROT, N_CELLS * N_CELLS)
    # The keypoint's rotation bin: a gather, exactly the JAX version's one-hot sum.
    bins = orb_ops.angle_bins(angles, N_ROT)
    desc = pooled.gather(2, bins[:, None, None, None].expand(K, N_OBINS, 1, N_CELLS * N_CELLS))[:, :, 0]
    desc = desc.transpose(1, 2).reshape(K, DESC_DIM)
    # SIFT's normalisation: L2, clip at 0.2, L2.
    desc = torch.clamp(desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9), max=0.2)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)


def _pad_edge32(p: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) -> (K, 32, 32), the last row and column repeated."""
    p = torch.cat([p, p[:, :, -1:]], dim=2)
    return torch.cat([p, p[:, -1:, :]], dim=1)


def detect_and_describe_gradhist(
    img: torch.Tensor,
    moment_w: torch.Tensor,
    num_features: int = 1000,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    edge_margin: int = 16,
    score: str = "fast",
) -> Features:
    """FAST (or Shi-Tomasi) keypoints + GradHist descriptors on one (H, W)
    image in [0, 255]; ``moment_w`` is the (961, 2) moment weights on the
    image's device. Descriptors are (K, 128) int32 words (bitcast f32). No
    kernel runs: the windows are gathered and the orientations computed in
    plain PyTorch, as the JAX version's XLA does."""
    H0, W0 = img.shape
    img = img.to(torch.float32)
    levels = pyr_ops.build_pyramid(img, n_levels, scale)
    quotas = level_quotas(num_features, n_levels, scale)
    outs = []
    for l, (lvl, k_l) in enumerate(zip(levels, quotas)):
        Hl, Wl = lvl.shape
        yx, resp, valid, sub = detect_level(lvl, k_l, threshold, grid, edge_margin, score)
        blurred = pyr_ops.gaussian_blur(lvl, sigma=2.0, radius=3)
        praw = orb_ops.extract_patches(lvl, yx)
        pblur = _pad_edge32(orb_ops.extract_patches(blurred, yx))
        ang = orb_ops.orientations(praw, moment_w)
        desc = gradhist_descriptors(pblur, ang).view(torch.int32)
        sx = W0 / Wl
        sy = H0 / Hl
        xy_full = torch.stack(
            [(yx[:, 1].to(torch.float32) + sub[:, 1]) * sx, (yx[:, 0].to(torch.float32) + sub[:, 0]) * sy], dim=-1
        )
        outs.append(Features(
            xy=xy_full, response=resp, angle=ang,
            octave=torch.full((k_l,), l, dtype=torch.int32, device=img.device),
            size=torch.full((k_l,), 31.0 * (sx + sy) * 0.5, dtype=torch.float32, device=img.device),
            desc=desc, valid=valid,
        ))
    return Features(*[torch.cat([getattr(o, f) for o in outs]) for f in Features._fields])
