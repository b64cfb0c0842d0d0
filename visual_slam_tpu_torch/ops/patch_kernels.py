"""Kernels K1 (the fused detection tail) and K5 (32x32 window gather) and
their plain PyTorch versions.

Ports of ``visual_slam_tpu.ops.pallas_patches.patches_and_moments_pallas``
(``csrc/patches_moments.cu``, one launch for all pyramid levels of a frame,
or of B frames in the batched VO step)
and ``extract_patches32_pallas`` (``csrc/extract_patches32.cu``).
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from .. import _build
from .orb import PATCH, RADIUS, extract_patches

_MAX_LEVELS = 16  # kMaxLevels of csrc/patches_moments.cu


def patches_and_moments_ref(
    img_raw: torch.Tensor, img_blur: torch.Tensor, yx: torch.Tensor, moment_w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (K, 2) moments (m10, m01) over the disk-masked 31x31
    window of the raw level (one product with the (961, 2) ``moment_w``),
    and the (K, 31, 31) windows of the blurred level."""
    raw = extract_patches(img_raw, yx)
    mom = raw.reshape(raw.shape[0], PATCH * PATCH) @ moment_w
    return mom, extract_patches(img_blur, yx)


def patches_and_moments_levels_ref(
    raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor],
    moment_w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the multi-level K1: ``patches_and_moments_ref`` on
    each level, concatenated level-major: (sum K_l, 2) moments and (sum K_l,
    31, 31) patches."""
    outs = [patches_and_moments_ref(r, b, yx, moment_w) for r, b, yx in zip(raws, blurs, yxs)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def patches_and_moments_batched_ref(
    raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor],
    moment_w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batched K1: ``patches_and_moments_levels_ref`` of
    each frame b of the (B, H_l, W_l) levels and (B, K_l, 2) keypoints,
    stacked: (B, sum K_l, 2) moments and (B, sum K_l, 31, 31) patches."""
    outs = [patches_and_moments_levels_ref([r[b] for r in raws], [x[b] for x in blurs], [y[b] for y in yxs],
                                           moment_w) for b in range(raws[0].shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _launch_patches_moments(fn: str, raws, blurs, yxs) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/patches_moments.cu`` over every level of one
    frame, (H_l, W_l) levels and (K_l, 2) keypoints, or of B frames, (B, H_l,
    W_l) and (B, K_l, 2); the outputs carry the same leading batch shape."""
    dev = raws[0].device
    n = len(raws)
    if not (len(blurs) == len(yxs) == n and 0 < n <= _MAX_LEVELS):
        raise ValueError(f"{fn}: {n} raw, {len(blurs)} blurred and {len(yxs)} keypoint levels; needs 1 to "
                         f"{_MAX_LEVELS} of each")
    batch = tuple(raws[0].shape[:-2])
    B = batch[0] if batch else 1
    if not 0 < B <= 65535:
        raise ValueError(f"{fn}: batch of {B} frames; needs 1 to 65535")
    for l, (raw, blur, yx) in enumerate(zip(raws, blurs, yxs)):
        _build.check_args(fn, dev, (
            (f"raws[{l}]", raw, torch.float32, batch + tuple(raw.shape[-2:])),
            (f"blurs[{l}]", blur, torch.float32, raw.shape),
            (f"yxs[{l}]", yx, torch.int32, batch + (yx.shape[-2], 2)),
        ))
    ks = [int(yx.shape[-2]) for yx in yxs]
    mom = torch.empty(batch + (sum(ks), 2), dtype=torch.float32, device=dev)
    patches = torch.empty(batch + (sum(ks), PATCH, PATCH), dtype=torch.float32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
    rc = _build.lib().vslam_patches_moments(
        n, B, ptrs(raws), ptrs(blurs), ptrs(yxs), ints([r.shape[-2] for r in raws]), ints([r.shape[-1] for r in raws]),
        ints(ks), mom.data_ptr(), patches.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "vslam_patches_moments")
    return mom, patches


def patches_and_moments_levels(
    raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor],
    moment_w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over every pyramid level of a frame in one launch: per level l the
    raw (H_l, W_l) level, its blurred copy and its (K_l, 2) int32 keypoints
    (y, x); returns the moments and blurred patches of all keypoints,
    level-major. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which derives the same disk-masked weights as ``moment_w`` from
    the integer window offsets."""
    dev = raws[0].device
    if dev.type == "cpu":
        return patches_and_moments_levels_ref(raws, blurs, yxs, moment_w)
    if dev.type != "cuda":
        raise ValueError(f"patches_and_moments_levels: no kernel for device {dev}")
    out = _launch_patches_moments("patches_and_moments_levels", raws, blurs, yxs)
    patches_and_moments_levels.launches += 1
    return out


patches_and_moments_levels.launches = 0


def patches_and_moments_batched(
    raws: Sequence[torch.Tensor], blurs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor],
    moment_w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over every pyramid level of B frames in one launch (the batched VO
    step): per level l the raw (B, H_l, W_l) levels, their blurred copies
    and (B, K_l, 2) int32 keypoints; returns (B, sum K_l, 2) moments and (B,
    sum K_l, 31, 31) patches, level-major within each frame. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    dev = raws[0].device
    if dev.type == "cpu":
        return patches_and_moments_batched_ref(raws, blurs, yxs, moment_w)
    if dev.type != "cuda":
        raise ValueError(f"patches_and_moments_batched: no kernel for device {dev}")
    out = _launch_patches_moments("patches_and_moments_batched", raws, blurs, yxs)
    patches_and_moments_batched.launches += 1
    return out


patches_and_moments_batched.launches = 0


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
