"""Kernels K1 (the fused detection tail) and K5 (32x32 window gather) and
their plain PyTorch versions.

Ports of ``visual_slam_tpu.ops.pallas_patches.patches_and_moments_pallas``
(``csrc/patches_moments.cu``) and ``extract_patches32_pallas``
(``csrc/extract_patches32.cu``).
"""
from __future__ import annotations

import torch

from .. import _build
from .orb import PATCH, RADIUS, extract_patches


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


P32 = 32  # rows and columns of a K5 window


def extract_patches32_ref(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: (H, W) image + (K, 2) integer (y, x) ->
    (K, 32, 32) windows of rows y-15 .. y+16 and columns x-15 .. x+16, each
    index clamped into the image (the JAX kernel's edge padding by R+1 = 16
    with the window origin at (y+1, x+1)). The top-left 31x31 equals
    ``orb.extract_patches`` for keypoints inside the image."""
    H, W = img.shape
    off = torch.arange(-RADIUS, P32 - RADIUS, device=yx.device)
    rows = (yx[:, 0].long()[:, None] + off).clamp(0, H - 1)
    cols = (yx[:, 1].long()[:, None] + off).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def extract_patches32(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """K5. CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if img.device.type == "cpu":
        return extract_patches32_ref(img, yx)
    if img.device.type != "cuda":
        raise ValueError(f"extract_patches32: no kernel for device {img.device}")
    H, W = img.shape
    K = yx.shape[0]
    _build.check_args("extract_patches32", img.device, (
        ("img", img, torch.float32, (H, W)),
        ("yx", yx, torch.int32, (K, 2)),
    ))
    out = torch.empty((K, P32, P32), dtype=torch.float32, device=img.device)
    rc = _build.lib().vslam_extract_patches32(
        img.data_ptr(), H, W, yx.data_ptr(), K, out.data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    _build.check(rc, "vslam_extract_patches32")
    extract_patches32.launches += 1
    return out


extract_patches32.launches = 0
