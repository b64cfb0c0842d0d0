"""Two-view epipolar geometry: essential and fundamental matrices by
fixed-budget RANSAC, and cheirality-based pose recovery
(port of ``visual_slam_tpu.ops.epipolar``).

Each RANSAC is a fixed batch of hypotheses: a minimal set per hypothesis,
a normalized 8-point fit, four wide-to-narrow inlier refits of every
hypothesis (LO-RANSAC), Sampson scoring, argmin. The JAX version ``vmap``s
over hypotheses; here the functions take leading batch dimensions. The
minimal sets come from a ``torch.Generator`` or are given as
``sample_idx`` (the tests feed the JAX sampler's draws). Nothing reads a
value back to the host apart from the rank-2 and essential ``svd``'s error
status (and, on CPU tensors only, ``nullspace_vector``'s ``eigh``).
"""
from __future__ import annotations

import math

import torch

from .lie import make_T
from .linalg import nullspace_vector
from .triangulation import projection_from_T, triangulate_dlt

_EPS = 1e-9


def _sample_minimal_sets(
    gen, mask: torch.Tensor, n_hyp: int, set_size: int
) -> torch.Tensor:
    """(n_hyp, set_size) int64 indices drawn uniformly, with replacement,
    from the entries where ``mask`` is True, by inverting the mask's
    cumulative count: no host round-trip. Torch cannot reproduce JAX's
    random bits, so only the distribution matches the JAX version (which
    draws from all entries when the mask is empty; here that case returns
    the last index, a degenerate hypothesis either way). A (B, N) ``mask``
    with a sequence of B generators (the batched VO step) draws each row's
    sets from its own generator, as B single calls would: (B, n_hyp,
    set_size)."""
    cdf = torch.cumsum(mask.to(torch.float32), dim=-1)
    if isinstance(gen, torch.Generator):
        u = torch.rand((n_hyp, set_size), generator=gen, device=mask.device)
    else:
        u = torch.stack([torch.rand((n_hyp, set_size), generator=g, device=mask.device) for g in gen])
    v = u * cdf[..., -1:, None]
    idx = torch.searchsorted(cdf, v.flatten(-2), right=True).reshape(v.shape)
    return torch.clamp(idx, max=mask.shape[-1] - 1) if mask.shape[-1] else idx


def _hartley_normalize(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Hartley normalization over the last-but-one axis: translate
    to the weighted centroid, scale the mean distance to sqrt(2). Returns
    (x_norm, S) with x_h_norm = S @ x_h; ``x`` (..., N, 2) and ``w`` (..., N)
    broadcast."""
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    mean = (x * w[..., None]).sum(-2) / wsum[..., None]
    xc = x - mean[..., None, :]
    d = torch.sqrt(torch.sum(xc * xc, dim=-1) + _EPS)
    scale = math.sqrt(2.0) / torch.clamp((d * w).sum(-1) / wsum, min=_EPS)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    S = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return xc * scale[..., None, None], S


def eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, essential: bool = True) -> torch.Tensor:
    """Weighted normalized 8-point algorithm: (..., N, 2) correspondences
    (normalized camera coordinates for E, pixels for F) and (..., N) weights
    -> (..., 3, 3) M with x2_h^T M x1_h = 0, projected onto the essential
    manifold (singular values 1, 1, 0) or to rank 2, unit Frobenius norm."""
    x1n, S1 = _hartley_normalize(x1, w)
    x2n, S2 = _hartley_normalize(x2, w)
    x1n, x2n = torch.broadcast_tensors(x1n, x2n)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)
    AtA = (A * w[..., None]).transpose(-1, -2) @ A  # (..., 9, 9)
    Fn = nullspace_vector(AtA).reshape(AtA.shape[:-2] + (3, 3))
    # Denormalize first: the similarities do not preserve singular values,
    # so the manifold projection happens in the original frame.
    F = S2.transpose(-1, -2) @ Fn @ S1
    U, s, Vt = torch.linalg.svd(F)
    if essential:
        s_new = torch.stack([torch.ones_like(s[..., 0]), torch.ones_like(s[..., 0]), torch.zeros_like(s[..., 0])], -1)
    else:
        s_new = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (U * s_new[..., None, :]) @ Vt
    return F / (torch.linalg.matrix_norm(F)[..., None, None] + _EPS)


def sampson_error(M: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance of x2^T M x1 = 0: (..., N)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Mx1 = x1h @ M.transpose(-1, -2)
    Mtx2 = x2h @ M
    num = torch.sum(x2h * Mx1, dim=-1) ** 2
    den = Mx1[..., 0] ** 2 + Mx1[..., 1] ** 2 + Mtx2[..., 0] ** 2 + Mtx2[..., 1] ** 2
    return num / torch.clamp(den, min=_EPS)


def _ransac_epipolar(x1, x2, mask, idx, thresh, essential: bool):
    """Shared body of both RANSACs: fit each minimal set, anneal every
    hypothesis through inlier refits at 64, 16, 4 and 1 times the squared
    threshold, score by truncated Sampson cost, take the argmin."""
    w8 = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    Ms = eight_point(x1[idx], x2[idx], w8, essential=essential)  # (H, 3, 3)
    t2 = thresh * thresh
    for factor in (64.0, 16.0, 4.0, 1.0):
        inl = (sampson_error(Ms, x1, x2) < factor * t2) & mask
        Ms = eight_point(x1, x2, inl.to(x1.dtype), essential=essential)
    errs = sampson_error(Ms, x1, x2)  # (H, N)
    cost = torch.where(mask[None, :], torch.clamp(errs, max=t2), 0.0).sum(-1)
    best = torch.argmin(cost)[None]  # index_select: indexing by a 0-d tensor reads it on the host
    M = Ms.index_select(0, best)[0]
    inliers = (sampson_error(M, x1, x2) < t2) & mask
    return M, inliers, cost.index_select(0, best)[0]


def ransac_essential(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    gen: torch.Generator | None = None,
    n_hyp: int = 256,
    thresh: float = 3e-3,
    sample_idx: torch.Tensor | None = None,
) -> dict:
    """Fixed-budget RANSAC for the essential matrix on normalized
    coordinates. ``sample_idx`` (n_hyp, 8) replaces the draws from ``gen``.
    Returns dict(E, inliers (N,), n_inliers, score)."""
    if sample_idx is None:
        sample_idx = _sample_minimal_sets(gen, mask, n_hyp, 8)
    E, inliers, score = _ransac_epipolar(x1, x2, mask, sample_idx.long(), thresh, essential=True)
    return {"E": E, "inliers": inliers, "n_inliers": inliers.sum(), "score": score}


def ransac_fundamental(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    gen: torch.Generator | None = None,
    n_hyp: int = 128,
    thresh: float = 1.0,
    sample_idx: torch.Tensor | None = None,
) -> dict:
    """RANSAC fundamental matrix on pixel coordinates (the geometric match
    filter). Returns dict(F, inliers (N,), n_inliers)."""
    if sample_idx is None:
        sample_idx = _sample_minimal_sets(gen, mask, n_hyp, 8)
    F, inliers, _ = _ransac_epipolar(x1, x2, mask, sample_idx.long(), thresh, essential=False)
    return {"F": F, "inliers": inliers, "n_inliers": inliers.sum()}


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> the 4 candidate (R, t): (4, 3, 3) and (4, 3), ||t|| = 1. The
    SVD's signs and order may differ from the JAX version's; the pose
    ``recover_pose`` selects does not."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.zeros((3, 3), dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> dict:
    """The (R, t) of E's decomposition with the most points in front of
    both cameras. (R, t) is T_ref->cur (x2 ~ R x1 + t), camera 1 at the
    origin. Returns dict(R, t, T (4, 4), good (N,), pts3d (N, 3), n_good)."""
    Rs, ts = decompose_essential(E)
    P1 = torch.cat([torch.eye(3, dtype=E.dtype, device=E.device), torch.zeros((3, 1), dtype=E.dtype, device=E.device)], 1)
    pts, w_ok = triangulate_dlt(P1, projection_from_T(make_T(Rs, ts)), x1, x2)  # (4, N, 3)
    z1 = pts[..., 2]
    z2 = (pts * Rs[:, None, 2, :]).sum(-1) + ts[:, 2:3]
    good = w_ok & (z1 > 0) & (z2 > 0) & mask
    counts = good.sum(-1)
    k = torch.argmax(counts)[None]

    def pick(a):
        return a.index_select(0, k)[0]

    R, t = pick(Rs), pick(ts)
    return {"R": R, "t": t, "T": make_T(R, t), "good": pick(good), "pts3d": pick(pts), "n_good": pick(counts)}


def estimate_motion_2d2d(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    gen: torch.Generator | None = None,
    n_hyp: int = 256,
    thresh: float = 3e-3,
    sample_idx: torch.Tensor | None = None,
) -> dict:
    """2D-2D relative motion: RANSAC essential matrix, then pose recovery.
    Returns R, t (T_ref->cur), T, E, inliers (cheirality-good) and n_inliers."""
    res = ransac_essential(x1, x2, mask, gen, n_hyp=n_hyp, thresh=thresh, sample_idx=sample_idx)
    pose = recover_pose(res["E"], x1, x2, res["inliers"])
    return {
        "R": pose["R"], "t": pose["t"], "T": pose["T"], "E": res["E"],
        "inliers": pose["good"], "n_inliers": pose["n_good"],
    }
