"""Triangulation: batched DLT plus Gauss-Newton refinement, and the closed-form
two-view depths of the RANSAC cheirality test
(counterpart of ``sfmfromscratch_tpu/geometry/triangulation.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sfmfromscratch_tpu_torch.ba.schur import segment_plan, segment_sum
from sfmfromscratch_tpu_torch.geometry.epipolar import hartley_normalize
from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


@mm_f32
def triangulate_dlt(p1: torch.Tensor, p2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """Batched linear triangulation: (..., N, 2) observations and (..., 3, 4)
    projections -> (..., N, 3) points. The null vector comes from the direct
    batched SVD (``nullvec_lstsq``), as in the JAX package."""
    x1, y1 = p1[..., 0:1], p1[..., 1:2]
    x2, y2 = p2[..., 0:1], p2[..., 1:2]
    P1b = P1[..., None, :, :]
    P2b = P2[..., None, :, :]
    rows = torch.stack(
        [
            x1 * P1b[..., 2, :] - P1b[..., 0, :],
            y1 * P1b[..., 2, :] - P1b[..., 1, :],
            x2 * P2b[..., 2, :] - P2b[..., 0, :],
            y2 * P2b[..., 2, :] - P2b[..., 1, :],
        ],
        dim=-2,
    )  # (..., N, 4, 4)
    X = nullvec_lstsq(rows)
    w = X[..., 3:4]
    tiny = torch.where(w < 0, -1e-12, 1e-12)
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, tiny, w)


@mm_f32
def triangulate_normalized(
    p1: torch.Tensor, p2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hartley-normalized DLT (``triangulation.py:61-70``): normalize the
    observations, transform the projections by the same similarities, then
    ``triangulate_dlt`` (reference ``triangulate_points``, SFM.py:291-305)."""
    p1n, T1 = hartley_normalize(p1, mask)
    p2n, T2 = hartley_normalize(p2, mask)
    return triangulate_dlt(p1n[..., :2], p2n[..., :2], T1 @ P1, T2 @ P2)


def _residuals_jac_batched(X: torch.Tensor, p: torch.Tensor, P: torch.Tensor):
    """Residual (N, 2) and analytic Jacobian (N, 2, 3) of one camera's
    reprojection for all points at once."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    h = Xh @ P.T                                             # (N, 3)
    z = torch.where(torch.abs(h[:, 2:3]) < 1e-12, 1e-12, h[:, 2:3])
    proj = h[:, :2] / z
    r = proj - p
    A = P[:2, :3][None, :, :]                                # (1, 2, 3)
    B = h[:, :2, None] * P[2, :3][None, None, :]             # (N, 2, 3)
    J = (A * z[:, :, None] - B) / (z[:, :, None] ** 2)
    return r, J


@mm_f32
def refine_points_gn(
    p3d: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    P1: torch.Tensor,
    P2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_iters: int = 10,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Batched Gauss-Newton refinement of reprojection error with poses
    fixed; a step that raises a point's cost is rejected for that point
    (reference SFM.py:255-289). The normal solves stay LU
    (``torch.linalg.solve``), the JAX package's accuracy anchor."""
    if mask is None:
        mask = torch.ones(p3d.shape[:-1], dtype=torch.bool, device=p3d.device)

    def cost(X):
        r1, _ = _residuals_jac_batched(X, p1, P1)
        r2, _ = _residuals_jac_batched(X, p2, P2)
        return torch.sum(r1 * r1, dim=-1) + torch.sum(r2 * r2, dim=-1)

    eye = damping * torch.eye(3, dtype=p3d.dtype, device=p3d.device)
    X = p3d
    for _ in range(num_iters):
        r1, J1 = _residuals_jac_batched(X, p1, P1)
        r2, J2 = _residuals_jac_batched(X, p2, P2)
        JtJ = (
            torch.einsum("nki,nkj->nij", J1, J1)
            + torch.einsum("nki,nkj->nij", J2, J2)
            + eye
        )
        g = torch.einsum("nki,nk->ni", J1, r1) + torch.einsum("nki,nk->ni", J2, r2)
        dx = torch.linalg.solve(JtJ, g[..., None])[..., 0]
        X_new = X - dx
        ok = torch.all(torch.isfinite(X_new), dim=-1) & (cost(X_new) <= cost(X)) & mask
        X = torch.where(ok[:, None], X_new, X)
    return X


@mm_f32
def triangulate_multiview(
    P_all: torch.Tensor,        # (C, 3, 4) projection matrices
    obs_cam: torch.Tensor,      # (O,) camera index per observation
    obs_pt: torch.Tensor,       # (O,) track index per observation
    obs_xy: torch.Tensor,       # (O, 2) pixel observations
    num_points: int,
    obs_w: Optional[torch.Tensor] = None,   # (O,) weights; 0 disables
    gn_iters: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched multiview DLT + Gauss-Newton over a flat observation list
    (triangulation.py:143-228): each track's 4x4 normal matrix of
    unit-normalised DLT rows is a segment sum, its null vector the smallest
    eigenvector (sign-free after dehomogenisation), and each GN step
    accumulates per-track 3x3 normal equations the same way and solves them
    by LU. A track's step is kept only if it lowers that track's cost and
    the track has 2 observations or more. Returns ``(X (num_points, 3),
    nobs (num_points,))``."""
    O = obs_xy.shape[0]
    cam, pt = obs_cam.long(), obs_pt.long()
    plan = segment_plan(pt, num_points)
    w = torch.ones((O,), dtype=obs_xy.dtype, device=obs_xy.device) if obs_w is None \
        else obs_w.to(obs_xy.dtype)
    P = P_all[cam]                                           # (O, 3, 4)
    u = obs_xy[..., 0:1]
    v = obs_xy[..., 1:2]
    r1 = u * P[:, 2, :] - P[:, 0, :]
    r2 = v * P[:, 2, :] - P[:, 1, :]
    r1 = r1 / torch.clamp_min(torch.linalg.norm(r1, dim=-1, keepdim=True), 1e-9)
    r2 = r2 / torch.clamp_min(torch.linalg.norm(r2, dim=-1, keepdim=True), 1e-9)
    M_obs = r1[:, :, None] * r1[:, None, :] + r2[:, :, None] * r2[:, None, :]
    M = segment_sum(w[:, None, None] * M_obs, plan)
    nobs = segment_sum((w > 0).to(w.dtype), plan).to(torch.int32)   # exact below 2^24 a track
    M = M + 1e-9 * torch.eye(4, dtype=M.dtype, device=M.device)
    _, V = torch.linalg.eigh(M)                              # ascending eigenvalues
    Xh = V[..., :, 0]
    wh = Xh[..., 3:4]
    tiny = torch.where(wh < 0, -1e-12, 1e-12)
    X = Xh[..., :3] / torch.where(torch.abs(wh) < 1e-12, tiny, wh)

    eye = 1e-6 * torch.eye(3, dtype=X.dtype, device=X.device)

    def obs_res_jac(X):
        Xo = X[pt]
        Xh = torch.cat([Xo, torch.ones_like(Xo[:, :1])], dim=-1)
        h = torch.einsum("oij,oj->oi", P, Xh)
        z = torch.where(torch.abs(h[:, 2:3]) < 1e-12, 1e-12, h[:, 2:3])
        r = h[:, :2] / z - obs_xy
        A = P[:, :2, :3]
        B = h[:, :2, None] * P[:, None, 2, :3]
        J = (A * z[:, :, None] - B) / (z[:, :, None] ** 2)
        return r * w[:, None], J * w[:, None, None]

    def track_cost(X):
        r, _ = obs_res_jac(X)
        return segment_sum(torch.sum(r * r, dim=-1), plan)

    for _ in range(gn_iters):
        r, J = obs_res_jac(X)
        JtJ = segment_sum(torch.einsum("oki,okj->oij", J, J), plan) + eye
        g = segment_sum(torch.einsum("oki,ok->oi", J, r), plan)
        dx = torch.linalg.solve(JtJ, g[..., None])[..., 0]
        X_new = X - dx
        ok = (torch.all(torch.isfinite(X_new), dim=-1)
              & (track_cost(X_new) <= track_cost(X)) & (nobs >= 2))
        X = torch.where(ok[:, None], X_new, X)
    return X, nobs


@mm_f32
def two_view_depths(
    R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
    K1: torch.Tensor, K2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form depths of (..., N, 2) correspondences under relative pose
    (R, t): z1 = (c x r2).(t x r2) / ||c x r2||^2 with c = R r1
    (replaces the reference's per-candidate DLT scan, SFM.py:105-124).

    K1, K2 are (3, 3), or carry the leading dimensions of the points, which
    makes this the JAX ``vmap`` of the function over those dimensions."""
    K1i = torch.linalg.inv(K1)
    K2i = torch.linalg.inv(K2)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]

    def backproject(Ki, u, v):
        k = [[Ki[..., a, b, None] for b in range(3)] for a in range(3)]
        return (
            k[0][0] * u + k[0][1] * v + k[0][2],
            k[1][0] * u + k[1][1] * v + k[1][2],
            k[2][0] * u + k[2][1] * v + k[2][2],
        )

    r1x, r1y, r1z = backproject(K1i, u1, v1)
    r2x, r2y, r2z = backproject(K2i, u2, v2)

    Rb = R[..., None]                               # (..., 3, 3, 1)
    cx_ = Rb[..., 0, 0, :] * r1x + Rb[..., 0, 1, :] * r1y + Rb[..., 0, 2, :] * r1z
    cy_ = Rb[..., 1, 0, :] * r1x + Rb[..., 1, 1, :] * r1y + Rb[..., 1, 2, :] * r1z
    cz_ = Rb[..., 2, 0, :] * r1x + Rb[..., 2, 1, :] * r1y + Rb[..., 2, 2, :] * r1z

    tb = t[..., None]                               # (..., 3, 1)
    tx_, ty_, tz_ = tb[..., 0, :], tb[..., 1, :], tb[..., 2, :]

    ax = cy_ * r2z - cz_ * r2y
    ay = cz_ * r2x - cx_ * r2z
    az = cx_ * r2y - cy_ * r2x
    bx = ty_ * r2z - tz_ * r2y
    by = tz_ * r2x - tx_ * r2z
    bz = tx_ * r2y - ty_ * r2x

    denom = ax * ax + ay * ay + az * az
    z1 = -(ax * bx + ay * by + az * bz) / torch.clamp_min(denom, 1e-12)
    z2 = z1 * cz_ + tz_
    return z1, z2
