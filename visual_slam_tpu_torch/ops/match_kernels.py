"""Kernels K2 and K4 (Hamming top-2, one and C candidate blocks), K3
(guided top-2) and their plain versions.

Ports of ``visual_slam_tpu.ops.pallas_kernels.hamming_top2`` (K2) and
``hamming_top2_batched`` with C > 1 (K4), both ``csrc/hamming_top2.cu``
(an int8 tensor-core tile kernel and its finisher) called with C = 1 or C;
and of ``guided_top2_pallas`` (K3), ``csrc/guided_top2.cu``. The batched VO
step takes K2 as ``hamming_top2_paired`` (B query blocks, each against its
own train block) and K3 as ``guided_top2_batched`` (B arenas against B
keypoint sets), one launch pair each for all B. Descriptors are (N, 8)
int32 words. Distances are exact integers either way, so kernel and plain
version agree exactly, ties included.
"""
from __future__ import annotations

import torch

from .. import _build
from .orb import unpack_bits

BIG = 1e9
_INT_MAX = 2**31 - 1
_TILE = 64  # query rows and train columns of a block of csrc/hamming_top2.cu


def hamming_distances(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., K1, 8) x (..., K2, 8) int32 words -> (..., K1, K2) int64
    Hamming distances, as the JAX package's XLA path computes them: |a| +
    |b| - 2 a.b over the unpacked 0/1 bits. Every partial sum is an integer
    below 2^24, so the f32 product is exact in any summation order (TF32
    is off), with or without leading batch dimensions."""
    b1 = unpack_bits(desc1)
    b2 = unpack_bits(desc2)
    d = b1.sum(-1)[..., :, None] + b2.sum(-1)[..., None, :] - 2.0 * (b1 @ b2.mT)
    return d.to(torch.int64)


def hamming_distance_matrix(
    desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
) -> torch.Tensor:
    """(..., K1, K2) float32 Hamming distances; invalid rows/columns get BIG."""
    d = hamming_distances(desc1, desc2).to(torch.float32)
    return torch.where(valid1[..., :, None] & valid2[..., None, :], d, BIG)


def top2(dist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second, argbest) along the last axis: argbest is the first
    minimum, second the minimum over every other column."""
    arg = torch.argmin(dist, dim=-1)
    best = torch.gather(dist, -1, arg[..., None])[..., 0]
    cols = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.where(cols == arg[..., None], torch.inf, dist).amin(-1)
    return best, second, arg


def hamming_top2_ref(
    desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: (best (K1,) f32, second (K1,) f32, argbest (K1,)
    int32, col_argmin (K2,) int32). Invalid pairs read as BIG."""
    d = hamming_distance_matrix(desc1, desc2, valid1, valid2)
    best, second, arg = top2(d)
    colarg = torch.argmin(d, dim=0)
    return best, second, arg.to(torch.int32), colarg.to(torch.int32)


def hamming_top2_batched_ref(
    desc_q: torch.Tensor, desc_c: torch.Tensor, valid_q: torch.Tensor, valid_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``hamming_top2_ref`` of the (K1, 8) query block
    against each of the (C, K2, 8) candidate blocks, stacked: best, second
    (C, K1) f32, argbest (C, K1) int32, col_argmin (C, K2) int32. One
    candidate at a time, as JAX's ``lax.map`` path: all C distance tables
    at once would hold C*K1*K2 values, 256M at C = 64 and K1 = K2 = 2000."""
    outs = [hamming_top2_ref(desc_q, desc_c[c], valid_q, valid_c[c]) for c in range(desc_c.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def hamming_top2_paired_ref(
    desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the paired K2: ``hamming_top2_ref`` of query block b
    (B, K1, 8) against train block b (B, K2, 8), stacked: best, second (B,
    K1) f32, argbest (B, K1) int32, col_argmin (B, K2) int32."""
    outs = [hamming_top2_ref(desc1[b], desc2[b], valid1[b], valid2[b]) for b in range(desc1.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def guided_top2_ref(
    lm_desc: torch.Tensor,
    lm_ok: torch.Tensor,
    lm_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_valid: torch.Tensor,
    kp_xy: torch.Tensor,
    radius2: torch.Tensor,
    ratio: float = 0.8,
    max_distance: float = 80.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: Hamming distances gated by |uv - xy|^2 <= r^2,
    per-landmark best/second with the ratio and absolute tests, then one
    landmark per keypoint by the minimum of (distance, landmark index).
    Returns (lm_idx (K,) int32, valid (K,) bool)."""
    M = lm_desc.shape[0]
    K = kp_desc.shape[0]
    du = lm_uv[:, None, 0] - kp_xy[None, :, 0]
    dv = lm_uv[:, None, 1] - kp_xy[None, :, 1]
    gate = du * du + dv * dv <= radius2
    d = torch.where(gate, hamming_distance_matrix(lm_desc, kp_desc, lm_ok, kp_valid), BIG)
    best, second, kp_of_lm = top2(d)
    ok = (best < BIG * 0.5) & (best <= max_distance) & (best < ratio * second)
    enc = torch.where(
        ok, best.to(torch.int64) * M + torch.arange(M, device=d.device), _INT_MAX
    )
    colenc = torch.full((K,), _INT_MAX, dtype=torch.int64, device=d.device)
    colenc = colenc.scatter_reduce(0, kp_of_lm, enc, "amin")
    valid = colenc < _INT_MAX
    lm_idx = torch.where(valid, colenc % M, 0)
    return lm_idx.to(torch.int32), valid


def guided_top2_batched_ref(lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio: float = 0.8,
                            max_distance: float = 80.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batched K3: ``guided_top2_ref`` of each sequence
    b, its (M, ...) arena against its (K, ...) keypoints with its squared
    radius ``radius2[b]``, stacked: lm_idx (B, K) int32, valid (B, K) bool."""
    outs = [guided_top2_ref(lm_desc[b], lm_ok[b], lm_uv[b], kp_desc[b], kp_valid[b], kp_xy[b], radius2[b], ratio,
                            max_distance) for b in range(lm_desc.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def _device(fn: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {t.device}")
    return t.device.type


def _launch_hamming_top2(name, desc_q, desc_c, valid_q, valid_c, paired: bool = False):
    """One call of ``csrc/hamming_top2.cu`` (the tile kernel and its
    finisher) over (C, K2, 8) candidate blocks; outputs carry the leading C
    axis. The query block is shared, (K1, 8), or ``paired``, (C, K1, 8)."""
    K1 = desc_q.shape[-2]
    C, K2 = desc_c.shape[:2]
    dev = desc_q.device
    qb = (C,) if paired else ()
    _build.check_args(name, dev, (
        ("desc_q", desc_q, torch.int32, qb + (K1, 8)),
        ("desc_c", desc_c, torch.int32, (C, K2, 8)),
        ("valid_q", valid_q, torch.bool, qb + (K1,)),
        ("valid_c", valid_c, torch.bool, (C, K2)),
    ))
    if not (0 < K1 and 257 * K1 < _INT_MAX and 0 < K2 <= _TILE * 65535 and 0 < C <= 65535 and C * K2 < _INT_MAX):
        raise ValueError(f"{name}: sizes K1={K1}, C={C}, K2={K2} out of the kernel's range")
    n_rt, n_ct = -(-K1 // _TILE), -(-K2 // _TILE)
    best = torch.empty((C, K1), dtype=torch.float32, device=dev)
    second = torch.empty((C, K1), dtype=torch.float32, device=dev)
    arg = torch.empty((C, K1), dtype=torch.int32, device=dev)
    colarg = torch.empty((C, K2), dtype=torch.int32, device=dev)
    # Scratch: each active 64 x 64 tile's row and column partials, and
    # which tiles were active (the others are never read).
    rowpart = torch.empty((C, n_ct, K1), dtype=torch.int64, device=dev)
    colpart = torch.empty((C, n_rt, K2), dtype=torch.int32, device=dev)
    active = torch.empty((C, n_rt, n_ct), dtype=torch.uint8, device=dev)
    rc = _build.lib().vslam_hamming_top2(
        desc_q.data_ptr(), valid_q.data_ptr(), K1, desc_c.data_ptr(), valid_c.data_ptr(), K2, C, int(paired),
        best.data_ptr(), second.data_ptr(), arg.data_ptr(), colarg.data_ptr(), rowpart.data_ptr(),
        colpart.data_ptr(), active.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "vslam_hamming_top2")
    return best, second, arg, colarg


def hamming_top2(
    desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2. CPU tensors take the plain version; CUDA tensors launch the kernel
    with one candidate block."""
    if _device("hamming_top2", desc1) == "cpu":
        return hamming_top2_ref(desc1, desc2, valid1, valid2)
    out = _launch_hamming_top2("hamming_top2", desc1, desc2[None], valid1, valid2[None])
    hamming_top2.launches += 1
    return tuple(o[0] for o in out)


hamming_top2.launches = 0


def hamming_top2_paired(
    desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 over B pairs of blocks (the batched VO step): query block b (B, K1,
    8) against train block b (B, K2, 8) -> best, second (B, K1) f32, argbest
    (B, K1) int32, col_argmin (B, K2) int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel once for all B pairs."""
    if _device("hamming_top2_paired", desc1) == "cpu":
        return hamming_top2_paired_ref(desc1, desc2, valid1, valid2)
    out = _launch_hamming_top2("hamming_top2_paired", desc1, desc2, valid1, valid2, paired=True)
    hamming_top2_paired.launches += 1
    return out


hamming_top2_paired.launches = 0


def hamming_top2_batched(
    desc_q: torch.Tensor, desc_c: torch.Tensor, valid_q: torch.Tensor, valid_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: one (K1, 8) query block against (C, K2, 8) candidate blocks ->
    best, second (C, K1) f32, argbest (C, K1) int32, col_argmin (C, K2)
    int32. CPU tensors take the plain version; CUDA tensors launch the
    kernel once for all C candidates."""
    if _device("hamming_top2_batched", desc_q) == "cpu":
        return hamming_top2_batched_ref(desc_q, desc_c, valid_q, valid_c)
    out = _launch_hamming_top2("hamming_top2_batched", desc_q, desc_c, valid_q, valid_c)
    hamming_top2_batched.launches += 1
    return out


hamming_top2_batched.launches = 0


def _launch_guided_top2(name, lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio, max_distance):
    """One call of ``csrc/guided_top2.cu`` (the fill and the matcher) for one
    arena, (M, ...) leaves and a 0-d ``radius2``, or for B, (B, M, ...)
    leaves and ``radius2`` (B,); the outputs carry the same batch shape."""
    batch = tuple(lm_desc.shape[:-2])
    B = batch[0] if batch else 1
    M, K = lm_desc.shape[-2], kp_desc.shape[-2]
    dev = lm_desc.device
    _build.check_args(name, dev, (
        ("lm_desc", lm_desc, torch.int32, batch + (M, 8)),
        ("lm_ok", lm_ok, torch.bool, batch + (M,)),
        ("lm_uv", lm_uv, torch.float32, batch + (M, 2)),
        ("kp_desc", kp_desc, torch.int32, batch + (K, 8)),
        ("kp_valid", kp_valid, torch.bool, batch + (K,)),
        ("kp_xy", kp_xy, torch.float32, batch + (K, 2)),
        ("radius2", radius2, torch.float32, batch),
    ))
    if not (0 < M and 257 * M < _INT_MAX and 0 < K and 0 < B <= 65535):
        raise ValueError(f"{name}: sizes B={B}, M={M}, K={K} out of the kernel's range")
    lm_idx = torch.empty(batch + (K,), dtype=torch.int32, device=dev)
    valid = torch.empty(batch + (K,), dtype=torch.bool, device=dev)
    colenc = torch.empty(batch + (K + 1,), dtype=torch.int32, device=dev)  # per-keypoint minima, then blocks done
    rc = _build.lib().vslam_guided_top2(
        lm_desc.data_ptr(), lm_ok.data_ptr(), lm_uv.data_ptr(), M,
        kp_desc.data_ptr(), kp_valid.data_ptr(), kp_xy.data_ptr(), K, B,
        radius2.data_ptr(), float(ratio), float(max_distance),
        colenc.data_ptr(), lm_idx.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "vslam_guided_top2")
    return lm_idx, valid


def guided_top2(
    lm_desc: torch.Tensor,
    lm_ok: torch.Tensor,
    lm_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_valid: torch.Tensor,
    kp_xy: torch.Tensor,
    radius2: torch.Tensor,
    ratio: float = 0.8,
    max_distance: float = 80.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3. CPU tensors take the plain version; CUDA tensors launch the
    kernel. ``radius2`` is a 0-d f32 tensor (the squared, dynamic radius)."""
    if _device("guided_top2", lm_desc) == "cpu":
        return guided_top2_ref(
            lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio, max_distance
        )
    out = _launch_guided_top2("guided_top2", lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio,
                              max_distance)
    guided_top2.launches += 1
    return out


guided_top2.launches = 0


def guided_top2_batched(lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio: float = 0.8,
                        max_distance: float = 80.0) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 over B sequences (the batched VO step): (B, M, ...) arenas against
    (B, K, ...) keypoints with ``radius2`` (B,), each sequence's squared
    radius -> lm_idx (B, K) int32, valid (B, K) bool. CPU tensors take the
    plain version; CUDA tensors launch the kernel once for all B."""
    if _device("guided_top2_batched", lm_desc) == "cpu":
        return guided_top2_batched_ref(lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio, max_distance)
    out = _launch_guided_top2("guided_top2_batched", lm_desc, lm_ok, lm_uv, kp_desc, kp_valid, kp_xy, radius2, ratio,
                              max_distance)
    guided_top2_batched.launches += 1
    return out


guided_top2_batched.launches = 0
