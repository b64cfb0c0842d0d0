"""Approximate nearest-neighbour Hamming matching: an inverted-file (IVF)
index (port of ``visual_slam_tpu.ops.ann``), plain PyTorch.

* build: ``C`` anchor rows drawn by numpy from ``seed`` (the JAX package's
  draw), every database row assigned to its nearest anchor by one dense
  Hamming matrix, buckets of a fixed capacity ``B`` filled on the host
  (overflow truncates: the usual IVF recall trade);
* search: each query scores the ``C`` anchors, probes its ``P`` nearest
  buckets (a stable sort: ties to the lower anchor, as ``lax.top_k``) and
  takes exact Hamming distances to the ``P * B`` gathered rows by XOR and a
  popcount of the int32 words, then the ratio test and ``unique_train`` of
  the exact matcher.

``frontend.matcher.FlannMatcher`` routes here at or above its
``ann_threshold`` binary train rows. No kernel of the port runs here: the
JAX package computes it with XLA (its Hamming matrices and
``population_count``).
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from .match_kernels import BIG, hamming_distance_matrix, top2
from .matching import unique_train


class IVFIndex(NamedTuple):
    """Fixed-capacity inverted file over (N, 8) int32 descriptor words."""

    anchors: torch.Tensor  # (C, 8) int32 coarse centroids (sampled rows)
    bucket_desc: torch.Tensor  # (C, B, 8) int32
    bucket_ids: torch.Tensor  # (C, B) int64 original row index (-1 = pad)
    bucket_valid: torch.Tensor  # (C, B) bool

    @property
    def n_clusters(self) -> int:
        return self.anchors.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.bucket_ids.shape[1]


def build_ivf_index(desc: torch.Tensor, valid: torch.Tensor, n_clusters: int = 64, bucket_cap: int | None = None,
                    seed: int = 0) -> IVFIndex:
    """Build the index over ``desc`` (N, 8) int32 words and their ``valid``
    mask, on their device: the (N, C) assignment runs there, the bucket
    fill on the host. Rebuild when the database changes."""
    device = desc.device
    desc_np, valid_np = desc.cpu().numpy(), valid.cpu().numpy()
    rng = np.random.default_rng(seed)
    valid_rows = np.nonzero(valid_np)[0]
    if len(valid_rows) == 0:
        raise ValueError("build_ivf_index: no valid descriptors")
    C = min(n_clusters, len(valid_rows))
    anchors = desc[torch.from_numpy(rng.choice(valid_rows, size=C, replace=False)).to(device)]
    d = hamming_distance_matrix(desc, anchors, valid, torch.ones(C, dtype=torch.bool, device=device))
    assign = np.argmin(d.cpu().numpy(), axis=1)
    assign[~valid_np] = -1
    counts = np.bincount(assign[valid_np], minlength=C)
    if bucket_cap is None:
        # Headroom over the fullest bucket, a multiple of 64.
        bucket_cap = int(np.ceil(2.0 * max(counts.max(), 1) / 64.0)) * 64
    B = bucket_cap
    bucket_desc = np.zeros((C, B, desc_np.shape[1]), np.int32)
    bucket_ids = np.full((C, B), -1, np.int64)
    bucket_valid = np.zeros((C, B), bool)
    n_trunc = 0
    for c in range(C):
        rows = np.nonzero(assign == c)[0]
        if len(rows) > B:
            n_trunc += len(rows) - B
            rows = rows[:B]
        bucket_desc[c, :len(rows)] = desc_np[rows]
        bucket_ids[c, :len(rows)] = rows
        bucket_valid[c, :len(rows)] = True
    if n_trunc:
        logging.getLogger("ann").info("IVF build: %d/%d descriptors truncated by bucket_cap=%d (recall trade: raise "
                                      "bucket_cap or n_clusters)", n_trunc, int(valid_np.sum()), B)
    return IVFIndex(anchors, *(torch.from_numpy(a).to(device) for a in (bucket_desc, bucket_ids, bucket_valid)))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, exactly, as int32: a SWAR count of
    each 16-bit half (``>>`` is arithmetic on int32, so every shift is
    masked, and no intermediate leaves [0, 2^16))."""
    total = torch.zeros_like(x)
    for half in (x & 0xFFFF, (x >> 16) & 0xFFFF):
        v = half - ((half >> 1) & 0x5555)
        v = (v & 0x3333) + ((v >> 2) & 0x3333)
        v = (v + (v >> 4)) & 0x0F0F
        total = total + ((v + (v >> 8)) & 0x1F)
    return total


def ivf_search(index: IVFIndex, qdesc: torch.Tensor, qvalid: torch.Tensor, n_probe: int = 4, ratio: float = 0.75,
               n_train: int | None = None) -> dict:
    """Match (Q, 8) int32 queries against the index: the exact matcher's
    table, ``train_idx (Q,)`` int64, ``distance (Q,)``, ``valid (Q,)`` and
    ``n_matches`` (no cross-check: an inverted file cannot answer it). A
    probe set with a single finite candidate passes the ratio test, as
    knn(2) does."""
    Q = qdesc.shape[0]
    P = min(n_probe, index.n_clusters)
    ones = torch.ones(index.n_clusters, dtype=torch.bool, device=qdesc.device)
    d_coarse = hamming_distance_matrix(qdesc, index.anchors, qvalid, ones)  # (Q, C)
    probe = torch.sort(d_coarse, dim=-1, stable=True).indices[:, :P]  # (Q, P), ties to the lower anchor
    cand_desc = index.bucket_desc[probe]  # (Q, P, B, 8)
    cand_valid = index.bucket_valid[probe]
    cand_ids = index.bucket_ids[probe]
    # Exact Hamming on the packed words, one word at a time: (Q, P, B) int32 temporaries.
    d = torch.zeros(cand_valid.shape, dtype=torch.int32, device=qdesc.device)
    for w in range(qdesc.shape[1]):
        d = d + popcount32(qdesc[:, None, None, w] ^ cand_desc[..., w])
    d = torch.where(cand_valid & qvalid[:, None, None], d.to(torch.float32), BIG).reshape(Q, -1)
    ids = cand_ids.reshape(Q, -1)
    best, second, ti_flat = top2(d)
    ti = ids.gather(1, ti_flat[:, None])[:, 0]
    ok = (best < BIG * 0.5) & qvalid
    if ratio > 0:
        ok = ok & ((second >= BIG * 0.5) | (best < ratio * second))
    ti = torch.clamp(ti, min=0)
    if n_train is not None:
        ok = unique_train(ti, best, ok, n_train)
    return {"train_idx": ti, "distance": best, "valid": ok, "n_matches": ok.sum()}
