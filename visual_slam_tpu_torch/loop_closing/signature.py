"""Compact global keyframe signatures for place recognition
(port of ``visual_slam_tpu.loop_closing.signature``, binary family).

A fixed random binary codebook of V visual words (seed 77, the same numpy
draw as the JAX package). Word assignment for all K descriptors is one
(K, 256) x (256, V) product of 0/1 bits with the +/-1 codebook, whose
argmax is the nearest word by Hamming distance; the signature is the
L2-normalised word histogram. Every projection is an integer held exactly
in f32 (with TF32 off, which the package sets), so ties are common and
``argmax`` must take the first index, as ``jnp.argmax`` does. Scoring is a
host-side numpy matvec over the signature table.

The float-descriptor codebook (SIFT/GradHist families) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.orb import N_BITS, unpack_bits

N_WORDS_VOCAB = 256  # visual-word count V


def _make_codebook(seed: int = 77) -> np.ndarray:
    """(256, V) +/-1 projection of V random binary words: for a bit vector
    b, Hamming(b, w) = const - b . (2w - 1), so the argmax of the
    projection is the nearest word."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2, size=(N_WORDS_VOCAB, N_BITS))
    return (2.0 * words - 1.0).T.astype(np.float32)


_CODEBOOK = torch.from_numpy(_make_codebook())


def keyframe_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., K, 8) int32 words + (..., K) mask -> (..., V) L2-normalised
    visual-word histogram, on the descriptors' device."""
    bits = unpack_bits(desc, dtype=torch.float32)  # (..., K, 256)
    proj = bits @ _CODEBOOK.to(desc.device)  # (..., K, V)
    word = torch.argmax(proj, dim=-1)
    hist = torch.zeros(word.shape[:-1] + (N_WORDS_VOCAB,), dtype=torch.float32, device=desc.device)
    hist = hist.scatter_add(-1, word, valid.to(torch.float32))
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    return hist / torch.clamp(norm, min=1e-9)


def batch_signatures(descs: torch.Tensor, valids: torch.Tensor) -> np.ndarray:
    """(N, K, 8) + (N, K) -> (N, V) numpy, in one batched pass on the
    descriptors' device (backfills keyframes without a signature)."""
    return keyframe_signature(descs, valids).cpu().numpy()


def score_signatures(query: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Centered-cosine place similarity of ``query`` (V,) against ``table``
    (N, V), on the host. Subtracting the table's mean histogram plays the
    role of TF-IDF: words every keyframe uses carry no place information."""
    mu = table.mean(axis=0)
    qc = query - mu
    tc = table - mu
    qn = qc / max(float(np.linalg.norm(qc)), 1e-9)
    tn = tc / np.maximum(np.linalg.norm(tc, axis=1, keepdims=True), 1e-9)
    return tn @ qn
