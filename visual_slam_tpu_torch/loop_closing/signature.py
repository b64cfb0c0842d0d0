"""Compact global keyframe signatures for place recognition
(port of ``visual_slam_tpu.loop_closing.signature``).

A fixed random codebook of V visual words, the same numpy draws as the
JAX package: binary words (seed 77) for the 256-bit families, random unit
directions (seed 78) for the float families (128-wide blocks, f32 bitcast
in int32 words). Word assignment for all K descriptors is one product
with the codebook, whose argmax is the nearest word: for binary blocks
the (K, 256) 0/1 bits against the +/-1 codebook (Hamming), for float
blocks the descriptors against the unit directions (L2 on unit-norm
descriptors). The signature is the L2-normalised word histogram. Every
binary projection is an integer held exactly in f32 (with TF32 off, which
the package sets), so ties are common and ``argmax`` must take the first
index, as ``jnp.argmax`` does. Scoring is a host-side numpy matvec over the
signature table.
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


def _make_codebook_float(dim: int = 128, seed: int = 78) -> np.ndarray:
    """(dim, V) random unit directions, the visual words of the float
    families: on unit-norm descriptors the nearest word under L2 is the
    argmax of the projection."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N_WORDS_VOCAB, dim)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return w.T


_CODEBOOK_F = torch.from_numpy(np.ascontiguousarray(_make_codebook_float()))


def keyframe_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., K, 8) int32 words, or (..., K, 128) bitcast float descriptors,
    + (..., K) mask -> (..., V) L2-normalised visual-word histogram, on the
    descriptors' device. The codebook follows the descriptor width."""
    if int(desc.shape[-1]) == 8:
        x, codebook = unpack_bits(desc, dtype=torch.float32), _CODEBOOK  # (..., K, 256)
    else:
        x, codebook = desc.view(torch.float32), _CODEBOOK_F  # (..., K, 128)
    proj = x @ codebook.to(desc.device)  # (..., K, V)
    word = torch.argmax(proj, dim=-1)
    hist = torch.zeros(word.shape[:-1] + (N_WORDS_VOCAB,), dtype=torch.float32, device=desc.device)
    hist = hist.scatter_add(-1, word, valid.to(torch.float32))
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    return hist / torch.clamp(norm, min=1e-9)


def batch_signatures(descs: torch.Tensor, valids: torch.Tensor) -> np.ndarray:
    """(N, K, W) + (N, K) -> (N, V) numpy, in one batched pass on the
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
