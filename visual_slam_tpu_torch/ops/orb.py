"""Oriented rBRIEF descriptors (port of ``visual_slam_tpu.ops.orb``).

The pattern, the 961-row rotated sampling matrix and the disk-masked
moment weights are built by the same numpy code from the same seed, so
they equal the JAX package's constants bit for bit.

Descriptors are 8 words of 32 bits per keypoint, stored as ``int32``: bit
for bit the JAX package's ``uint32`` words (torch's ``uint32`` supports
too few operations).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

PATCH = 31
RADIUS = PATCH // 2  # 15
PATTERN_CLIP = 12
N_BITS = 256
N_WORDS = N_BITS // 32
N_BINS = 30  # steering quantization: 12 degrees per bin


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) float32: 256 pairs of (y, x) offsets, Gaussian sigma =
    PATCH/5, clipped to a rotation-safe disk."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norms > PATTERN_CLIP, pts * (PATTERN_CLIP / norms), pts)
    return pts.astype(np.float32)


_yy, _xx = np.mgrid[-RADIUS : RADIUS + 1, -RADIUS : RADIUS + 1]
_DISK = (_yy**2 + _xx**2 <= RADIUS**2).astype(np.float32)

# (961, 2): disk-masked x / y moment weights (m10, m01).
MOMENT_W_NP = np.stack(
    [(_xx * _DISK).astype(np.float32).reshape(-1), (_yy * _DISK).astype(np.float32).reshape(-1)],
    axis=-1,
)


def _make_rotated_sampling_matrices() -> np.ndarray:
    """(961, N_BINS * 512) bilinear sampling weights: column (b*512 + s)
    samples pattern point s rotated by angle 2pi*b/N_BINS."""
    pts = _make_pattern().reshape(-1, 2)  # (512, 2) as (y, x)
    S = np.zeros((PATCH * PATCH, N_BINS * 2 * N_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        ry = s * pts[:, 1] + c * pts[:, 0] + RADIUS
        rx = c * pts[:, 1] - s * pts[:, 0] + RADIUS
        y0 = np.clip(np.floor(ry), 0, PATCH - 2).astype(int)
        x0 = np.clip(np.floor(rx), 0, PATCH - 2).astype(int)
        fy = ry - y0
        fx = rx - x0
        for si in range(2 * N_BITS):
            col = b * 2 * N_BITS + si
            base = y0[si] * PATCH + x0[si]
            S[base, col] += (1 - fy[si]) * (1 - fx[si])
            S[base + 1, col] += (1 - fy[si]) * fx[si]
            S[base + PATCH, col] += fy[si] * (1 - fx[si])
            S[base + PATCH + 1, col] += fy[si] * fx[si]
    return S


@functools.cache
def sampling_matrix_np() -> np.ndarray:
    """The (961, 15360) rotated-BRIEF sampling matrix (59 MB), built on
    first use (about half a second) and read-only: callers copy it."""
    S = _make_rotated_sampling_matrices()
    S.setflags(write=False)
    return S


def extract_patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) windows centred on integer keypoints ``yx (K, 2)``, with
    edge replication. The centre is first clamped to [-1, H] x [-1, W]: the
    JAX version slices a 16-pixel edge-padded image and ``dynamic_slice``
    clamps the window start, which matters only for the grid's padding
    slots (invalid keypoints past the image)."""
    H, W = img.shape
    off = torch.arange(-RADIUS, RADIUS + 1, device=yx.device)
    rows = (yx[:, 0].long().clamp(-1, H)[:, None] + off).clamp(0, H - 1)
    cols = (yx[:, 1].long().clamp(-1, W)[:, None] + off).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def orientations(patches: torch.Tensor, moment_w: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per (K, 31, 31) patch: one (K, 961) x (961, 2)
    product, then atan2(m01, m10)."""
    m = patches.reshape(patches.shape[0], -1) @ moment_w
    return torch.atan2(m[:, 1], m[:, 0])


def floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod(x, y)`` for y > 0, as JAX computes it: fmod, then shift a
    negative remainder by the divisor."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & (m < 0), m + y, m)


def angle_bins(angles: torch.Tensor, n_bins: int = N_BINS) -> torch.Tensor:
    """Steering bin of each angle: floor(mod(a, 2pi) / 2pi * n_bins) % n_bins."""
    two_pi = 2.0 * math.pi
    m = floor_mod(angles, two_pi)
    return torch.remainder(torch.floor(m / two_pi * n_bins).to(torch.int64), n_bins)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) 0/1 -> (..., 8) int32 words, bit s of word w = bits[32w + s]."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], N_WORDS, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    v = torch.sum(b << shifts, dim=-1)
    return torch.where(v > 2**31 - 1, v - 2**32, v).to(torch.int32)


def descriptors(
    patches: torch.Tensor, angles: torch.Tensor, sampling: torch.Tensor
) -> torch.Tensor:
    """Steered BRIEF: (..., K, 31, 31) blurred patches + (..., K) angles ->
    (..., K, 8) int32. All 30 rotations are sampled by one product of every
    keypoint (of every frame of a batch) with the (961, 15360) matrix; each
    keypoint keeps its own bin's 512 samples."""
    lead = patches.shape[:-2]
    samples_all = (patches.reshape(-1, PATCH * PATCH) @ sampling).reshape(*lead, N_BINS, 2 * N_BITS)
    bins = angle_bins(angles)
    vals = samples_all.gather(-2, bins[..., None, None].expand(*lead, 1, 2 * N_BITS))
    vals = vals.reshape(*lead, N_BITS, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


def unpack_bits(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) 0/1 in ``dtype``."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], N_BITS).to(dtype)
