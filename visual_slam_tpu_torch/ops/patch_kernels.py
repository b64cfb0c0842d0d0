"""Kernel K1, the fused detection tail, and its plain PyTorch version.

Port of ``visual_slam_tpu.ops.pallas_patches.patches_and_moments_pallas``.
The CUDA kernel is ``csrc/patches_moments.cu``.
"""
from __future__ import annotations

import torch

from .. import _build
from .orb import PATCH, extract_patches


def patches_and_moments_ref(
    img_raw: torch.Tensor, img_blur: torch.Tensor, yx: torch.Tensor, moment_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (K, 2) moments (m10, m01) over the disk-masked 31x31
    window of the raw level (one product with the (961, 2) ``moment_w``),
    and the (K, 31, 31) windows of the blurred level."""
    raw = extract_patches(img_raw, yx)
    mom = raw.reshape(raw.shape[0], -1) @ moment_w
    return mom, extract_patches(img_blur, yx)


def patches_and_moments(
    img_raw: torch.Tensor, img_blur: torch.Tensor, yx: torch.Tensor, moment_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: moments and blurred patches. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which derives the same disk-masked
    weights as ``moment_w`` from the integer window offsets."""
    if img_raw.device.type == "cpu":
        return patches_and_moments_ref(img_raw, img_blur, yx, moment_w)
    if img_raw.device.type != "cuda":
        raise ValueError(f"patches_and_moments: no kernel for device {img_raw.device}")
    H, W = img_raw.shape
    K = yx.shape[0]
    _build.check_args("patches_and_moments", img_raw.device, (
        ("img_raw", img_raw, torch.float32, (H, W)),
        ("img_blur", img_blur, torch.float32, (H, W)),
        ("yx", yx, torch.int32, (K, 2)),
    ))
    mom = torch.empty((K, 2), dtype=torch.float32, device=img_raw.device)
    patches = torch.empty((K, PATCH, PATCH), dtype=torch.float32, device=img_raw.device)
    rc = _build.lib().vslam_patches_moments(
        img_raw.data_ptr(), img_blur.data_ptr(), H, W, yx.data_ptr(), K,
        mom.data_ptr(), patches.data_ptr(), torch.cuda.current_stream(img_raw.device).cuda_stream,
    )
    _build.check(rc, "vslam_patches_moments")
    patches_and_moments.launches += 1
    return mom, patches


patches_and_moments.launches = 0
