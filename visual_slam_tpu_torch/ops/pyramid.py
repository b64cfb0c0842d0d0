"""Image pyramid + Gaussian smoothing (port of ``visual_slam_tpu.ops.pyramid``).

Images are (..., H, W): a leading batch of frames (the batched VO step)
goes through every function at once."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / torch.sum(k)).to(device)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur as 2*(2r+1) shifted adds, in the JAX
    version's order (horizontal pass, then vertical), so the f32 rounding
    follows it term by term."""
    k = gaussian_kernel1d(sigma, radius).tolist()
    *batch, H, W = img.shape
    p = pad_replicate(img, radius)
    out = torch.zeros((*batch, H + 2 * radius, W), dtype=img.dtype, device=img.device)
    for i in range(2 * radius + 1):
        out = out + k[i] * p[..., :, i : i + W]
    out2 = torch.zeros((*batch, H, W), dtype=img.dtype, device=img.device)
    for i in range(2 * radius + 1):
        out2 = out2 + k[i] * out[..., i : i + H, :]
    return out2


def pad_replicate(img: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2r, W + 2r), edges replicated."""
    *batch, H, W = img.shape
    return F.pad(img.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate").reshape(*batch, H + 2 * r, W + 2 * r)


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale**l
        shapes.append((max(int(round(height / s)), 16), max(int(round(width / s)), 16)))
    return shapes


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in, out) f32 weights of ``jax.image.resize(..., "linear")`` along one
    axis, by JAX's own formula (``compute_weight_mat`` in
    ``jax/_src/image/scale.py``): when downsampling, the triangle kernel is
    widened by 1/scale (antialiasing) and each output column normalised.
    ``torch.nn.functional.interpolate`` does not antialias this way."""
    inv_scale = 1.0 / (out_size / in_size)  # rounded twice, as JAX does
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps, w / total, 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased linear resize as two matmuls with the per-axis weights."""
    H, W = img.shape[-2:]
    Ho, Wo = shape
    out = img
    if Ho != H:
        out = resize_weights(H, Ho, img.device).T @ out
    if Wo != W:
        out = out @ resize_weights(W, Wo, img.device)
    return out


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """List of (..., H_l, W_l) float32 levels; level 0 is the input, each
    next level resized from the previous one."""
    H, W = img.shape[-2:]
    shapes = pyramid_shapes(H, W, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[l]))
    return levels
