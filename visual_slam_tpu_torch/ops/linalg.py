"""Small-matrix linear algebra (port of ``visual_slam_tpu.ops.linalg``).

Only the ``eigh`` branch of ``nullspace_vector`` is ported, on every
device: the JAX package's Cholesky inverse iteration exists for the TPU's
data-dependently slow batched ``eigh``.
"""
from __future__ import annotations

import torch


def nullspace_vector(AtA: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric
    ``(..., n, n)`` batch (DLT-style Gram matrices)."""
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]
