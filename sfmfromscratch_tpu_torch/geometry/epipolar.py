"""Epipolar geometry: Hartley normalization, the 8-point algorithm, epipolar
distances, and essential-matrix construction
(counterpart of ``sfmfromscratch_tpu/geometry/epipolar.py``).

Every function is mask-aware and batched over leading hypothesis dimensions,
and runs its matmuls in full float32 (``mm_f32``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq, project_rank2
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


@mm_f32
def hartley_normalize(
    pts: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translate (..., N, 2) points to zero mean and scale the mean radius to
    sqrt(2). Returns homogeneous normalized points (..., N, 3) and the
    (..., 3, 3) transform T with x_norm = T x (reference SFM.py:162-178)."""
    if mask is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = mask.to(pts.dtype)
    count = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / count[..., None]
    centered = pts - mean
    dist = torch.linalg.norm(centered, dim=-1)
    mean_dist = torch.sum(dist * w, dim=-1) / count[..., 0]
    scale = torch.tensor(math.sqrt(2.0), dtype=pts.dtype, device=pts.device) / torch.clamp_min(mean_dist, 1e-12)

    s = scale[..., None, None]
    cu = mean[..., 0, 0][..., None, None]
    cv = mean[..., 0, 1][..., None, None]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.cat(
        [
            torch.cat([s, z, -s * cu], dim=-1),
            torch.cat([z, s, -s * cv], dim=-1),
            torch.cat([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return pts_h @ T.transpose(-1, -2), T


def _constraint_rows(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """Rows of the 8-point constraint matrix, ordered so that A f = 0 with
    f = vec(F) row-major, i.e. x2^T F x1 = 0 (reference SFM.py:199-220)."""
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    return torch.stack(
        [x1 * x2, y1 * x2, x2, x1 * y2, y1 * y2, y2, x1, y1, ones], dim=-1
    )


@mm_f32
def eight_point_fundamental(
    p1: torch.Tensor, p2: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Normalized 8-point fundamental matrix for (..., N, 2) correspondences
    (reference SFM.py:190-236), batched over leading dimensions."""
    p1n, T1 = hartley_normalize(p1, mask)
    p2n, T2 = hartley_normalize(p2, mask)
    A = _constraint_rows(p1n, p2n)
    if mask is not None:
        A = A * mask[..., None].to(A.dtype)
    f = nullvec_lstsq(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    F = project_rank2(F)
    return T2.transpose(-1, -2) @ F @ T1


@mm_f32
def epipolar_distances(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Point-to-epipolar-line distances in image 2: |l . x2| / ||l_xy||,
    l = F x1 (reference SFM.py:86-95). F is (..., 3, 3); points (N, 2) or
    (..., N, 2); the result broadcasts to (..., N)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    Fb = F[..., None]
    l0 = Fb[..., 0, 0, :] * x1 + Fb[..., 0, 1, :] * y1 + Fb[..., 0, 2, :]
    l1 = Fb[..., 1, 0, :] * x1 + Fb[..., 1, 1, :] * y1 + Fb[..., 1, 2, :]
    l2 = Fb[..., 2, 0, :] * x1 + Fb[..., 2, 1, :] * y1 + Fb[..., 2, 2, :]
    num = torch.abs(l0 * x2 + l1 * y2 + l2)
    den = torch.sqrt(l0 * l0 + l1 * l1)
    return num / torch.clamp_min(den, 1e-12)


@mm_f32
def symmetric_epipolar_distances(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Max of the two directed point-line distances."""
    d12 = epipolar_distances(F, p1, p2)
    d21 = epipolar_distances(F.transpose(-1, -2), p2, p1)
    return torch.maximum(d12, d21)


@mm_f32
def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1 (reference SFM.py:58)."""
    return K2.transpose(-1, -2) @ F @ K1
