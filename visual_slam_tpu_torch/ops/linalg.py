"""Small-matrix linear algebra (port of ``visual_slam_tpu.ops.linalg``).

``nullspace_vector`` dispatches as the JAX package's does, with the
tensor's device in the backend's place: ``eigh`` on CPU tensors (the
numerics every CPU test is held to), and on CUDA tensors the direct method
``smallest_eigvec_psd``, whose Cholesky and triangular solves read nothing
back to the host where cuSOLVER's ``eigh`` checks its error status on every
call.
"""
from __future__ import annotations

import math

import torch


def smallest_eigvec_psd(AtA: torch.Tensor, iters: int = 4, shift: float = 2e-5) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a PSD ``(..., n, n)``
    batch by inverse iteration off one Cholesky factor, as the JAX
    function: Jacobi equilibration ``D A D`` (``D = diag(A)^-1/2``), a
    shift ``eps I`` that keeps a minimal sample's f32-indefinite Gram
    factorable, the fixed start ``cos(1.7 k + 0.3)``, ``iters`` solves each
    renormalised, and the result mapped back through ``D`` and renormalised.
    A failed factorization gives NaN, as JAX's Cholesky does; nothing is
    checked on the host."""
    n = AtA.shape[-1]
    d = torch.diagonal(AtA, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-20))
    Ah = AtA * s[..., :, None] * s[..., None, :]  # unit diagonal
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    L, info = torch.linalg.cholesky_ex(Ah + shift * eye)
    L = torch.where((info == 0)[..., None, None], L, math.nan)
    k = torch.arange(n, dtype=AtA.dtype, device=AtA.device)
    x = torch.cos(k * 1.7 + 0.3).expand(AtA.shape[:-1])[..., None]
    for _ in range(iters):
        y = torch.linalg.solve_triangular(L, x, upper=False)
        y = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-2, keepdim=True), min=1e-20)
    x = x[..., 0] * s  # back to the original coordinates
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-20)


def nullspace_vector(AtA: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric
    ``(..., n, n)`` batch (DLT-style Gram matrices): ``eigh`` on CPU
    tensors, ``smallest_eigvec_psd`` on CUDA tensors."""
    if AtA.is_cuda:
        return smallest_eigvec_psd(AtA)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]
