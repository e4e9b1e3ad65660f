"""Planar two-view geometry: homography fit, degeneracy detection and pose
from a homography (counterpart of the part of
``sfmfromscratch_tpu/geometry/homography.py`` that the global engine's
planar-degeneracy fix calls).

Every function takes leading batch dimensions, the JAX ``vmap``s included.
The decomposition follows Faugeras & Lustman: SVD of the calibrated
homography, 8 (R, t, n) candidates, ranked by cheirality. The SVD's sign
choices are free in both packages, so the order of the 8 candidates (and the
sign of a pair of them) may differ from XLA's; the selected candidate is the
one whose cheirality vote is highest, which does not depend on that order
except where two votes tie.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfmfromscratch_tpu_torch.geometry.epipolar import epipolar_distances
from sfmfromscratch_tpu_torch.geometry.triangulation import two_view_depths
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class HomographyFit(NamedTuple):
    H: torch.Tensor            # (..., 3, 3) image-space homography, p2 ~ H p1
    num_inliers: torch.Tensor  # (...,) symmetric-transfer inliers
    ok: torch.Tensor           # (...,) fit succeeded (enough support)


class HomographyPose(NamedTuple):
    """Top-2 cheirality-ranked decompositions; candidate 0 has the higher
    vote."""

    R: torch.Tensor            # (..., 2, 3, 3)
    t: torch.Tensor            # (..., 2, 3) unit norm
    n: torch.Tensor            # (..., 2, 3) plane normal in camera 1
    num_pos: torch.Tensor      # (..., 2) cheirality-positive points per candidate
    ok: torch.Tensor           # (...,) decomposition well-posed (candidate 0)


def _normalize_points(p, mask):
    """Hartley normalisation (masked): centroid 0, mean distance sqrt(2)."""
    w = mask.to(p.dtype)
    cnt = torch.clamp_min(torch.sum(w, -1), 1.0)
    mean = torch.sum(p * w[..., None], -2) / cnt[..., None]
    d = torch.sqrt(torch.sum((p - mean[..., None, :]) ** 2, -1))
    scale = math.sqrt(2.0) / torch.clamp_min(torch.sum(d * w, -1) / cnt, 1e-8)
    z = torch.zeros_like(scale)
    o = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, z, -scale * mean[..., 0]], -1),
        torch.stack([z, scale, -scale * mean[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    pn = (p - mean[..., None, :]) * scale[..., None, None]
    return pn, T


def _dlt_homography(p1n, p2n, w):
    """Weighted DLT: the null vector of A^T W A (smallest eigenvector, sign
    free) for (..., N, 2) normalised points; returns (..., 3, 3)."""
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], -1)
    A = torch.cat([r1, r2], -2)                            # (..., 2N, 9)
    ww = torch.cat([w, w], -1)
    AtA = torch.einsum("...ni,...n,...nj->...ij", A, ww, A)
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _transfer_err2(H, p1, p2):
    """Squared forward transfer error ||p2 - H p1||^2 (image units)."""
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    q = torch.einsum("...ij,...nj->...ni", H, p1h)
    q = q[..., :2] / torch.where(torch.abs(q[..., 2:3]) < 1e-12, 1e-12, q[..., 2:3])
    return torch.sum((q - p2) ** 2, -1)


@mm_f32
def fit_homography(
    p1: torch.Tensor,          # (..., N, 2)
    p2: torch.Tensor,          # (..., N, 2)
    mask: torch.Tensor,        # (..., N) bool
    threshold: float = 2.0,
    irls_rounds: int = 3,
) -> HomographyFit:
    """Masked IRLS homography fit and its symmetric-transfer inlier count at
    ``threshold`` px (homography.py:106-138): a DLT fit, then
    ``irls_rounds`` of truncated-quadratic reweighting."""
    thr2 = threshold * threshold
    p1n, T1 = _normalize_points(p1, mask)
    p2n, T2 = _normalize_points(p2, mask)
    mf = mask.to(p1.dtype)
    Hn = _dlt_homography(p1n, p2n, mf)
    for _ in range(irls_rounds):
        H = torch.linalg.solve(T2, Hn @ T1)
        e2 = _transfer_err2(H, p1, p2)
        w = mf * (e2 < thr2).to(p1.dtype)
        Hn = _dlt_homography(p1n, p2n, w + 1e-3 * mf)
    H = torch.linalg.solve(T2, Hn @ T1)
    e2f = _transfer_err2(H, p1, p2)
    # inv_ex: a padded edge's (all-false mask) H may be singular; XLA's inv
    # returns non-finite values there without raising.
    b2f = _transfer_err2(torch.linalg.inv_ex(H)[0], p2, p1)
    inl = (e2f < thr2) & (b2f < thr2) & mask
    num = torch.sum(inl, -1)
    return HomographyFit(H=H, num_inliers=num, ok=num >= 8)


def _rot_y_like(c, s, sign):
    """[[c, 0, -sign s], [0, sign, 0], [s, 0, sign c]] stacked over (...)."""
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, -sign * s], -1),
        torch.stack([z, sign * o, z], -1),
        torch.stack([s, z, sign * c], -1),
    ], -2)


def _faugeras_candidates(Hc):
    """All 8 Faugeras (R, t, n) solutions for (..., 3, 3) calibrated
    homographies, mapped back from the SVD frame: R = s U R' V^T, t = U t',
    n = V n' (homography.py:141-203)."""
    U, S, Vt = torch.linalg.svd(Hc)
    V = Vt.transpose(-1, -2)
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    eps = 1e-9
    den = torch.clamp_min(d1 ** 2 - d3 ** 2, eps)
    x1 = torch.sqrt(torch.clamp_min((d1 ** 2 - d2 ** 2) / den, 0.0))
    x3 = torch.sqrt(torch.clamp_min((d2 ** 2 - d3 ** 2) / den, 0.0))
    d2s = torch.clamp_min(d2, eps)
    zero = torch.zeros_like(d1)

    outsR, outsT, outsN = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            npl = torch.stack([x1 * e1, zero, x3 * e3], -1)
            # d' = +d2
            sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2s
            cos_t = (d1 * x3 ** 2 + d3 * x1 ** 2) / d2s
            outsR.append(_rot_y_like(cos_t, sin_t, 1.0))
            outsT.append(torch.stack([(d1 - d3) * x1 * e1, zero, -(d1 - d3) * x3 * e3], -1))
            outsN.append(npl)
            # d' = -d2
            sin_p = (d1 + d3) * x1 * x3 * e1 * e3 / d2s
            cos_p = (d3 * x1 ** 2 - d1 * x3 ** 2) / d2s
            outsR.append(_rot_y_like(cos_p, sin_p, -1.0))
            outsT.append(torch.stack([(d1 + d3) * x1 * e1, zero, (d1 + d3) * x3 * e3], -1))
            outsN.append(npl)

    Rs = torch.stack(outsR, -3)                            # (..., 8, 3, 3)
    ts = torch.stack(outsT, -2)                            # (..., 8, 3)
    ns = torch.stack(outsN, -2)
    R = s[..., None, None, None] * torch.einsum("...ij,...cjk,...lk->...cil", U, Rs, V)
    t = torch.einsum("...ij,...cj->...ci", U, ts)
    n = torch.einsum("...ij,...cj->...ci", V, ns)
    t = t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-12)
    return R, t, n


@mm_f32
def pose_from_homography(
    H: torch.Tensor,           # (..., 3, 3) image-space homography
    K1: torch.Tensor,          # (..., 3, 3)
    K2: torch.Tensor,
    p1: torch.Tensor,          # (..., N, 2)
    p2: torch.Tensor,
    mask: torch.Tensor,        # (..., N) bool: points the plane explains
) -> HomographyPose:
    """Relative pose of camera 2 w.r.t. camera 1 from a homography
    (homography.py:206-255): the calibrated homography, sign-normalised so
    x2^T Hc x1 > 0 over the masked points, decomposed into the 8 Faugeras
    candidates; the top two by cheirality vote (positive depth in both
    cameras and positive plane depth), near-duplicates of the winner
    suppressed. ``ok`` when the winner's vote reaches half the masked points
    and 8."""
    Hc = torch.linalg.solve(K2, H @ K1)
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    x1c = torch.einsum("...ij,...nj->...ni", torch.linalg.inv(K1), x1)
    x2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    x2c = torch.einsum("...ij,...nj->...ni", torch.linalg.inv(K2), x2)
    dots = torch.einsum("...ni,...ij,...nj->...n", x2c, Hc, x1c) * mask.to(H.dtype)
    sgn = torch.where(torch.sum(dots, -1) < 0, -1.0, 1.0)
    Hc = Hc * sgn[..., None, None]

    R, t, n = _faugeras_candidates(Hc)                     # (..., 8, 3, 3), (..., 8, 3)
    z1, z2 = two_view_depths(R, t, p1[..., None, :, :], p2[..., None, :, :],
                             K1[..., None, :, :], K2[..., None, :, :])   # (..., 8, N)
    pos = (z1 > 1e-6) & (z2 > 1e-6) & mask[..., None, :]
    nd = torch.einsum("...cj,...nj->...cn", n, x1c)
    score = torch.sum(pos & (nd > 0), -1)                  # (..., 8)

    best = torch.argmax(score, dim=-1, keepdim=True)
    R0 = torch.take_along_dim(R, best[..., None, None], dim=-3)
    dup = torch.sum((R - R0) ** 2, (-1, -2)) < 1e-6
    second = torch.argmax(torch.where(dup, -1, score), dim=-1, keepdim=True)
    idx = torch.cat([best, second], -1)                    # (..., 2)
    num_pos = torch.take_along_dim(score, idx, dim=-1)
    n_valid = torch.sum(mask, -1)
    ok = num_pos[..., 0] >= torch.clamp_min(0.5 * n_valid, 8.0)
    return HomographyPose(
        R=torch.take_along_dim(R, idx[..., None, None], dim=-3),
        t=torch.take_along_dim(t, idx[..., None], dim=-2),
        n=torch.take_along_dim(n, idx[..., None], dim=-2),
        num_pos=num_pos, ok=ok,
    )


# The JAX package's vmaps over an edge axis: the functions take leading
# dimensions already.
pose_from_homography_batch = pose_from_homography


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ], -2)


@mm_f32
def candidate_epipolar_rms(
    R2: torch.Tensor,          # (..., 2, 3, 3) pose candidates
    t2: torch.Tensor,          # (..., 2, 3)
    K1: torch.Tensor, K2: torch.Tensor,
    p1: torch.Tensor, p2: torch.Tensor,    # (..., N, 2)
    off_mask: torch.Tensor,    # (..., N) points off the dominant plane
):
    """RMS epipolar distance of off-plane points under each candidate's
    essential geometry, and their count (homography.py:275-298): only
    off-plane structure separates the twofold ambiguity."""
    E = _skew(t2) @ R2
    K2iT = torch.linalg.inv(K2).transpose(-1, -2)
    K1i = torch.linalg.inv(K1)
    F = torch.einsum("...ij,...cjk,...kl->...cil", K2iT, E, K1i)
    d = epipolar_distances(F, p1[..., None, :, :], p2[..., None, :, :])   # (..., 2, N)
    w = off_mask.to(d.dtype)
    cnt = torch.sum(w, -1)
    rms = torch.sqrt(torch.sum(d * d * w[..., None, :], -1) / torch.clamp_min(cnt, 1.0)[..., None])
    return rms, cnt


candidate_epipolar_rms_batch = candidate_epipolar_rms
