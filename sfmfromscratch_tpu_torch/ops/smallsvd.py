"""Batched small-matrix null spaces and decompositions
(counterpart of ``sfmfromscratch_tpu/ops/smallsvd.py``).

The solvers stay where the JAX package put them: complete QR for the
underdetermined 8x9 RANSAC minimal systems, QR then SVD for square and
overdetermined systems (the DLT null vector), SVD for the 3x3 rank-2
projection and the essential-matrix decomposition.
"""

from __future__ import annotations

import torch


def nullvec_lstsq(A: torch.Tensor) -> torch.Tensor:
    """Unit vector x minimizing ||A x|| for (..., m, n) A: the last
    right-singular vector of A (reference SFM.py:222-227, :249)."""
    m, n = A.shape[-2], A.shape[-1]
    if m < n:
        # Rank-m minimal systems have an exact 1-D null space, spanned by the
        # last column of the complete Q of A^T.
        Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
        v = Q[..., :, -1]
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)
    if m > n:
        A = torch.linalg.qr(A, mode="r").R                 # (..., n, n)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    v = Vh[..., -1, :]
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def project_rank2(F: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices to rank 2 by zeroing the smallest
    singular value (reference SFM.py:229-232)."""
    U, s, Vh = torch.linalg.svd(F, full_matrices=False)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vh


def decompose_essential(E: torch.Tensor):
    """Decompose (..., 3, 3) essential matrices into the two rotation
    candidates and the translation direction (reference SFM.py:62-81).
    Returns (R1, R2, t) with det(R) = +1 enforced."""
    U, _, Vh = torch.linalg.svd(E, full_matrices=False)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))[..., None, None]
    R2 = R2 * torch.sign(torch.linalg.det(R2))[..., None, None]
    t = U[..., :, 2]
    return R1, R2, t
