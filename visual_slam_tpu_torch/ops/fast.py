"""FAST-9/16 corner detection, NMS, grid top-k and subpixel refinement
(port of ``visual_slam_tpu.ops.fast``).

Slot order matters downstream (matcher ties resolve toward the stronger
feature), so every top-k here is a stable descending sort: equal scores
keep the lower index first, as ``lax.top_k`` does. Score maps are (..., H,
W): a leading batch of frames goes through at once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pyramid import pad_replicate

# FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9
BORDER = 3


def _ring(img: torch.Tensor) -> list[torch.Tensor]:
    """The 16 ring neighbours of every pixel, edge-replicated at the border."""
    H, W = img.shape[-2:]
    p = pad_replicate(img, BORDER)
    return [p[..., BORDER + dy : BORDER + dy + H, BORDER + dx : BORDER + dx + W] for dy, dx in RING_OFFSETS]


def _has_arc(mask16: torch.Tensor) -> torch.Tensor:
    """Circular run of >= ARC_LEN set bits in a 16-bit ring mask."""
    m = mask16 | (mask16 << 16)
    r = m
    for k in range(1, ARC_LEN):
        r = r & (m >> k)
    return (r & 0xFFFF) != 0


def interior_mask(H: int, W: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(..., H, W) FAST-9/16 score map: 0 for non-corners, else the SAD score
    of the winning polarity. The 16 ring terms are summed in ring order."""
    H, W = img.shape[-2:]
    thr = float(threshold)  # a Python scalar: no host-to-device copy
    hi = img + thr
    lo = img - thr
    bmask = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dmask = torch.zeros_like(bmask)
    bscore = torch.zeros_like(img)
    dscore = torch.zeros_like(img)
    for i, r in enumerate(_ring(img)):
        bright = r > hi
        dark = r < lo
        bmask = bmask + bright.to(torch.int32) * (1 << i)
        dmask = dmask + dark.to(torch.int32) * (1 << i)
        bscore = bscore + torch.where(bright, r - img - thr, 0.0)
        dscore = dscore + torch.where(dark, img - r - thr, 0.0)
    score = torch.maximum(
        torch.where(_has_arc(bmask), bscore, 0.0), torch.where(_has_arc(dmask), dscore, 0.0)
    )
    return torch.where(interior_mask(H, W, BORDER, img.device), score, 0.0)


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def shi_tomasi_scores(img: torch.Tensor, quality_level: float = 0.01, window: int = 5) -> torch.Tensor:
    """(..., H, W) Shi-Tomasi (min-eigenvalue) corner map: Sobel gradients,
    the structure tensor box-summed over ``window`` x ``window`` (zero
    'SAME' padding, as the JAX version's convolutions), its smaller
    eigenvalue, zeroed at the border and at or below ``quality_level``
    times the frame's maximum (cv2's goodFeaturesToTrack rule)."""
    *batch, H, W = img.shape
    x = img.reshape(-1, 1, H, W)
    sob_x = torch.tensor(_SOBEL_X, dtype=img.dtype, device=img.device)
    k = torch.stack([sob_x, sob_x.T])[:, None]  # (2, 1, 3, 3): gx, gy
    g = F.conv2d(x, k, padding=1)
    gx, gy = g[:, 0], g[:, 1]
    prods = torch.stack([gx * gx, gy * gy, gx * gy], dim=1)
    box = torch.ones((3, 1, window, window), dtype=img.dtype, device=img.device)
    S = F.conv2d(prods, box, padding=window // 2, groups=3)
    Sxx, Syy, Sxy = S[:, 0], S[:, 1], S[:, 2]
    half_tr = 0.5 * (Sxx + Syy)
    half_df = 0.5 * (Sxx - Syy)
    lam_min = half_tr - torch.sqrt(half_df * half_df + Sxy * Sxy)
    lam_min = torch.where(interior_mask(H, W, BORDER, img.device), lam_min, 0.0).reshape(*batch, H, W)
    thresh = float(quality_level) * lam_min.amax(dim=(-2, -1), keepdim=True)
    return torch.where(lam_min > thresh, lam_min, 0.0)


def _pool3(x: torch.Tensor, fill: float, op) -> torch.Tensor:
    """3x3 'SAME' pooling with ``fill`` outside the image, as shifted slices."""
    H, W = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    out = p[..., 0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = op(out, p[..., dy : dy + H, dx : dx + W])
    return out


def nms(scores: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression with exact tie-break toward the
    lexicographically first pixel of a plateau."""
    H, W = scores.shape[-2:]
    pooled = _pool3(scores, float("-inf"), torch.maximum)
    is_max = (scores >= pooled) & (scores > 0.0)
    idx = torch.arange(H * W, device=scores.device, dtype=torch.int32).reshape(H, W)
    big = H * W + 1
    tie_idx = torch.where(is_max, idx, big)
    pooled_idx = _pool3(tie_idx, big, torch.minimum)
    keep = is_max & (idx <= pooled_idx)
    return torch.where(keep, scores, 0.0)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last axis: descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_grid(
    scores: torch.Tensor, k: int, grid: int = 8, per_cell_factor: int = 2
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially balanced top-k: each of ``grid x grid`` cells keeps its
    best ``per_cell_factor * ceil(k / grid^2)`` corners, then the global
    top-k of the survivors. Returns (yx (..., k, 2) int32, score (..., k),
    valid (..., k))."""
    *batch, H, W = scores.shape
    g = grid
    cap = -(-k // (g * g)) * per_cell_factor
    ph = -(-H // g) * g - H
    pw = -(-W // g) * g - W
    s = F.pad(scores, (0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    ch, cw = Hp // g, Wp // g
    cells = s.reshape(*batch, g, ch, g, cw).transpose(-3, -2).reshape(*batch, g * g, ch * cw)
    cell_scores, cell_idx = _top_k(cells, cap)
    cell = torch.arange(g * g, device=scores.device)
    abs_y = (cell // g)[:, None] * ch + cell_idx // cw
    abs_x = (cell % g)[:, None] * cw + cell_idx % cw
    top_scores, top_i = _top_k(cell_scores.reshape(*batch, -1), k)
    yx = torch.stack([a.reshape(*batch, -1).gather(-1, top_i) for a in (abs_y, abs_x)], dim=-1)
    return yx.to(torch.int32), top_scores, top_scores > 0.0


def subpixel_offsets(scores: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Separable 1-D quadratic fit on the score surface around each
    selected pixel: (..., k, 2) (dy, dx) in [-0.5, 0.5]. Indices past the
    edge clamp, as JAX's gather does (padding slots of the grid can sit
    there)."""
    p = F.pad(scores, (1, 1, 1, 1))
    Hp, Wp = p.shape[-2:]
    flat = p.flatten(-2)
    y = yx[..., 0].long() + 1
    x = yx[..., 1].long() + 1

    def at(yy, xx):
        return flat.gather(-1, yy.clamp(0, Hp - 1) * Wp + xx.clamp(0, Wp - 1))

    def fit(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    s0 = at(y, x)
    dy = fit(at(y - 1, x), s0, at(y + 1, x))
    dx = fit(at(y, x - 1), s0, at(y, x + 1))
    return torch.stack([dy, dx], dim=-1)
