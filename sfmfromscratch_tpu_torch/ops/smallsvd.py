"""Batched small-matrix null spaces and decompositions
(counterpart of ``sfmfromscratch_tpu/ops/smallsvd.py``).

The solvers stay where the JAX package put them: complete QR for the
underdetermined 8x9 RANSAC minimal systems, QR then SVD for square and
overdetermined systems (the DLT null vector), SVD for the 3x3 rank-2
projection and the essential-matrix decomposition, and ``eigh`` of the
normal matrix where the JAX package takes it (the DLT PnP hypotheses, whose
Hartley-normalised systems are benign). The 3x3 closed forms
(``inv3``, ``chol3``, ``solve3_spd``, ``inv3_spd``) serve P3P and the point
blocks of bundle adjustment.
"""

from __future__ import annotations

import torch

from sfmfromscratch_tpu_torch.ops.cuda.nullvec_kernel import nullvec_8x9, nullvec_qr_plain


def nullvec_lstsq(A: torch.Tensor) -> torch.Tensor:
    """Unit vector x minimizing ||A x|| for (..., m, n) A: the last
    right-singular vector of A (reference SFM.py:222-227, :249). The 8x9
    minimal systems of the 8-point solves go to ``nullvec_8x9``: one kernel
    launch for all of them on the card."""
    m, n = A.shape[-2], A.shape[-1]
    if m < n:
        # Rank-m minimal systems have an exact 1-D null space, spanned by the
        # last column of the complete Q of A^T.
        if (m, n) == (8, 9):
            return nullvec_8x9(A)
        return nullvec_qr_plain(A)
    if m > n:
        A = torch.linalg.qr(A, mode="r").R                 # (..., n, n)
    # A system with a non-finite entry gives NaN, as XLA's SVD does, where
    # torch.linalg.svd would raise (a failed PnP pose triangulates so).
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    _, _, Vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, A), full_matrices=False)
    v = Vh[..., -1, :]
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.where(bad[..., None], float("nan"), v)


def smallest_eigvec_sym(S: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a symmetric (..., n, n)
    matrix (``eigh`` returns ascending eigenvalues). Defined up to sign."""
    _, vecs = torch.linalg.eigh(S)
    return vecs[..., :, 0]


def nullvec_normal_eq(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector of (..., m, n) A through ``eigh(A^T A)``: cheaper
    than :func:`nullvec_lstsq` and less accurate (the normal matrix squares
    the condition number), so only where conditioning is benign. A system
    with a non-finite entry gives NaN, as XLA's ``eigh`` does, where
    ``torch.linalg.eigh`` may raise."""
    AtA = torch.einsum("...mi,...mj->...ij", A, A)
    bad = ~torch.isfinite(AtA).all(dim=-1).all(dim=-1)
    v = smallest_eigvec_sym(torch.where(bad[..., None, None], 0.0, AtA))
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.where(bad[..., None], float("nan"), v)


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


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det), |det| floored at
    1e-30; the P3P polish and polar iteration use it."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def chol3(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form batched 3x3 Cholesky factor L (M = L L^T) of SPD
    matrices; ``eps`` adds a diagonal floor."""
    l00 = torch.sqrt(torch.clamp_min(M[..., 0, 0] + eps, 1e-30))
    l10 = M[..., 1, 0] / l00
    l20 = M[..., 2, 0] / l00
    l11 = torch.sqrt(torch.clamp_min(M[..., 1, 1] + eps - l10 * l10, 1e-30))
    l21 = (M[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(M[..., 2, 2] + eps - l20 * l20 - l21 * l21, 1e-30))
    z = torch.zeros_like(l00)
    return torch.stack(
        [
            torch.stack([l00, z, z], dim=-1),
            torch.stack([l10, l11, z], dim=-1),
            torch.stack([l20, l21, l22], dim=-1),
        ],
        dim=-2,
    )


def solve3_spd(M: torch.Tensor, g: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Solve M x = g for batched SPD 3x3 M through the closed-form Cholesky."""
    L = chol3(M, eps)
    y0 = g[..., 0] / L[..., 0, 0]
    y1 = (g[..., 1] - L[..., 1, 0] * y0) / L[..., 1, 1]
    y2 = (g[..., 2] - L[..., 2, 0] * y0 - L[..., 2, 1] * y1) / L[..., 2, 2]
    x2 = y2 / L[..., 2, 2]
    x1 = (y1 - L[..., 2, 1] * x2) / L[..., 1, 1]
    x0 = (y0 - L[..., 1, 0] * x1 - L[..., 2, 0] * x2) / L[..., 0, 0]
    return torch.stack([x0, x1, x2], dim=-1)


def inv3_spd(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Batched SPD 3x3 inverse L^-T L^-1 through the closed-form Cholesky,
    with the triangular inverse written out; BA's point blocks use it."""
    L = chol3(M, eps)
    i00 = 1.0 / L[..., 0, 0]
    i11 = 1.0 / L[..., 1, 1]
    i22 = 1.0 / L[..., 2, 2]
    i10 = -L[..., 1, 0] * i00 * i11
    i20 = (L[..., 1, 0] * L[..., 2, 1] - L[..., 2, 0] * L[..., 1, 1]) * i00 * i11 * i22
    i21 = -L[..., 2, 1] * i11 * i22
    z = torch.zeros_like(i00)
    Li = torch.stack(
        [
            torch.stack([i00, z, z], dim=-1),
            torch.stack([i10, i11, z], dim=-1),
            torch.stack([i20, i21, i22], dim=-1),
        ],
        dim=-2,
    )
    return Li.transpose(-1, -2) @ Li
