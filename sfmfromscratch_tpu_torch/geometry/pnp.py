"""Perspective-n-Point pose estimation: P3P or DLT hypotheses + RANSAC + a
Levenberg-Marquardt polish (counterpart of ``sfmfromscratch_tpu/geometry/pnp.py``).

Replaces the reference's ``cv2.solvePnPRansac`` and ``cv2.solvePnP``
(PoseEstimator.py:7-105): every hypothesis of the sample batch (Grunert P3P
on 3-point samples, or the Hartley-normalised 6-point DLT) is scored at once
by reprojection error, the winner is polished by fixed-iteration LM over
(so3, t) on its inliers with the Jacobian from forward-mode AD through
``so3_exp`` (``torch.func.jacfwd``, as ``jax.jacfwd`` there). ``pnp`` is the
non-robust DLT on every valid point plus the same polish.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sfmfromscratch_tpu_torch.geometry.p3p import p3p_poses
from sfmfromscratch_tpu_torch.geometry.ransac import (  # noqa: F401  (sample_minimal_indices: JAX's name)
    draw_uniforms,
    sample_minimal_indices,
    uniforms_to_indices,
)
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log
from sfmfromscratch_tpu_torch.ops.smallsvd import nullvec_lstsq, nullvec_normal_eq
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class PnPResult(NamedTuple):
    R: torch.Tensor            # (3, 3)
    t: torch.Tensor            # (3,)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # ()
    ok: torch.Tensor           # () bool: enough support to trust the pose


def _similarity(s: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """(..., d+1, d+1) transform x -> s (x - mean) in homogeneous form, for
    scales (...,) and means (..., d)."""
    d = mean.shape[-1]
    eye = torch.eye(d, dtype=mean.dtype, device=mean.device)
    top = torch.cat([s[..., None, None] * eye, (-s[..., None] * mean)[..., None]], dim=-1)
    last = torch.zeros(mean.shape[:-1] + (1, d + 1), dtype=mean.dtype, device=mean.device)
    last[..., 0, d] = 1.0
    return torch.cat([top, last], dim=-2)


def _normalize(x: torch.Tensor, w: Optional[torch.Tensor], radius: float):
    """Zero-mean / ``radius``-mean-norm similarity of (..., M, d) points
    under weights (..., M); returns (x_norm, T (..., d+1, d+1))."""
    ww = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if w is None else w.to(x.dtype)
    cnt = torch.clamp_min(torch.sum(ww, dim=-1, keepdim=True), 1.0)          # (..., 1)
    mean = torch.sum(x * ww[..., None], dim=-2, keepdim=True) / cnt[..., None]
    centered = x - mean
    rad = torch.sum(torch.linalg.norm(centered, dim=-1) * ww, dim=-1) / cnt[..., 0]
    s = math.sqrt(radius) / torch.clamp_min(rad, 1e-12)
    return centered * s[..., None, None], _similarity(s, mean[..., 0, :])


def _normalize_2d(x: torch.Tensor, w: Optional[torch.Tensor] = None):
    """Zero-mean / sqrt(2)-radius similarity for (..., M, 2) pixels; returns
    (x_norm, T (..., 3, 3)) with x_n = T x_h (``pnp.py:42-68``)."""
    return _normalize(x, w, 2.0)


def _normalize_3d(X: torch.Tensor, w: Optional[torch.Tensor] = None):
    """Zero-mean / sqrt(3)-radius similarity for (..., M, 3) world points;
    returns (X_norm, U (..., 4, 4)) with X_n_h = U X_h (``pnp.py:71-98``)."""
    return _normalize(X, w, 3.0)


def _dlt_projection(X: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor] = None,
                    precise: bool = True) -> torch.Tensor:
    """(..., M, 3) world points + (..., M, 2) pixels -> (..., 3, 4)
    projection matrix from the normalised 2M x 12 DLT system, rows weighted
    by ``w`` (``pnp.py:101-130``). ``precise=False`` takes the null vector
    from ``eigh(A^T A)`` (the RANSAC hypotheses), else from the SVD. A
    normalising transform that does not invert (a degenerate sample) gives
    NaN, as XLA's ``inv`` does, and the hypothesis scores no inlier."""
    xn, T = _normalize_2d(x, w)
    Xn, Unorm = _normalize_3d(X, w)
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)        # (..., M, 4)
    zero = torch.zeros_like(Xh)
    u, v = xn[..., 0:1], xn[..., 1:2]
    r1 = torch.cat([Xh, zero, -u * Xh], dim=-1)                       # (..., M, 12)
    r2 = torch.cat([zero, Xh, -v * Xh], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], dim=-2)                                   # (..., 2M, 12)
    p = nullvec_lstsq(A) if precise else nullvec_normal_eq(A)
    Pn = p.reshape(p.shape[:-1] + (3, 4))
    Tinv, info = torch.linalg.inv_ex(T)
    Tinv = torch.where((info != 0)[..., None, None], float("nan"), Tinv)
    return Tinv @ Pn @ Unorm


def _pose_from_projection(P: torch.Tensor, K: torch.Tensor):
    """Factor (..., 3, 4) P ~ K [R | t] (``pnp.py:133-153``): M = K^-1 P =
    s [R | t], the signed scale s = cbrt(det M[:, :3]) resolves the DLT's
    sign, and the rotation block is projected to SO(3) by Procrustes. A
    non-finite P gives a NaN pose, where ``torch.linalg.svd`` would raise."""
    M = torch.linalg.inv(K) @ P
    A = M[..., :, :3]
    detA = torch.linalg.det(A)
    s = torch.sign(detA) * torch.abs(detA) ** (1.0 / 3.0)
    s_safe = torch.where(torch.abs(s) < 1e-12, 1e-12, s)
    An = A / s_safe[..., None, None]
    bad = ~torch.isfinite(An).all(dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=An.dtype, device=An.device)
    U, _, Vh = torch.linalg.svd(torch.where(bad[..., None, None], eye, An))
    flip = torch.where(torch.linalg.det(U @ Vh) < 0, -1.0, 1.0)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]], dim=-1)
    R = torch.where(bad[..., None, None], float("nan"), U @ Vh)
    t = M[..., :, 3] / s_safe[..., None]
    return R, t


def _reproj_errors(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor, X: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """(..., N) pixel reprojection errors of (N, 3) points under poses
    (..., 3, 3), (..., 3), component-wise."""
    P = K @ torch.cat([R, t[..., :, None]], dim=-1)          # (..., 3, 4)
    Xx, Xy, Xz = X[:, 0], X[:, 1], X[:, 2]
    Pb = P[..., None]                                        # (..., 3, 4, 1)
    h0 = Pb[..., 0, 0, :] * Xx + Pb[..., 0, 1, :] * Xy + Pb[..., 0, 2, :] * Xz + Pb[..., 0, 3, :]
    h1 = Pb[..., 1, 0, :] * Xx + Pb[..., 1, 1, :] * Xy + Pb[..., 1, 2, :] * Xz + Pb[..., 1, 3, :]
    h2 = Pb[..., 2, 0, :] * Xx + Pb[..., 2, 1, :] * Xy + Pb[..., 2, 2, :] * Xz + Pb[..., 2, 3, :]
    z = torch.where(torch.abs(h2) < 1e-12, 1e-12, h2)
    du = h0 / z - x[:, 0]
    dv = h1 / z - x[:, 1]
    return torch.sqrt(du * du + dv * dv)


def _lm_refine(rvec0, t0, K, X, x, w, num_iters: int = 10):
    """Levenberg-Marquardt on (rvec, t) minimizing weighted reprojection
    error: ``num_iters`` steps, each kept only if it lowers the cost."""

    def residuals(params):
        R = so3_exp(params[:3])
        cam = X @ R.T + params[3:]
        pix = cam @ K.T
        z = pix[:, 2:3]
        proj = pix[:, :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        return ((proj - x) * w[:, None]).reshape(-1)

    def cost(params):
        r = residuals(params)
        return torch.sum(r * r)

    params = torch.cat([rvec0, t0])
    lam = torch.tensor(1e-3, dtype=params.dtype, device=params.device)
    for _ in range(num_iters):
        r = residuals(params)
        J = torch.func.jacfwd(residuals)(params)             # (2N, 6)
        JtJ = J.T @ J
        g = J.T @ r
        H = JtJ + lam * torch.diag(torch.diagonal(JtJ) + 1e-9)
        dp = torch.linalg.solve_ex(H, g)[0]
        new_params = params - dp
        improved = cost(new_params) < cost(params)
        params = torch.where(improved, new_params, params)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return params[:3], params[3:]


@mm_f32
def pnp_ransac(
    generator: Optional[torch.Generator],
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_hypotheses: int = 1000,
    reproj_threshold: float = 8.0,
    sample_size: Optional[int] = None,
    refine_iters: int = 10,
    min_points: int = 4,
    solver: str = "p3p",
    uniforms: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Robust 2D-3D pose (reference ``PnPRansac``, PoseEstimator.py:32-69).

    ``solver="p3p"``: 3-point samples, up to 4 Grunert poses each;
    ``solver="dlt"``: 6-point samples, one DLT pose each (``eigh`` null
    vector). Every hypothesis is scored by reprojection error under
    ``reproj_threshold``; the winner is LM-polished on its inliers and the
    polish is kept unless it loses inliers. Returns world-to-camera (R, t);
    ``ok`` is False below ``min_points`` of support. ``uniforms``
    (num_hypotheses, sample_size) replaces the draw from ``generator``.
    """
    if solver not in ("p3p", "dlt"):
        raise ValueError(f"pnp_ransac solver must be 'p3p' or 'dlt', got {solver!r}")
    n = points3d.shape[0]
    dev = points3d.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    n_valid = torch.sum(mask)
    if sample_size is None:
        sample_size = 3 if solver == "p3p" else 6

    if uniforms is None:
        uniforms = draw_uniforms(generator, num_hypotheses, sample_size, dev)
    idx = uniforms_to_indices(uniforms.to(dev), n, mask, sample_size)
    if solver == "p3p":
        Rh, th, vh = p3p_poses(points3d[idx], points2d[idx], K)  # (B, 4, ...)
        R = Rh.reshape(-1, 3, 3)                                 # (4B, 3, 3)
        t = th.reshape(-1, 3)
        hyp_ok = vh.reshape(-1)
    else:
        P = _dlt_projection(points3d[idx], points2d[idx], precise=False)   # (B, 3, 4)
        R, t = _pose_from_projection(P, K)
        hyp_ok = torch.ones(R.shape[:1], dtype=torch.bool, device=dev)

    errs = _reproj_errors(R, t, K, points3d, points2d)       # (4B, N)
    inl = (errs < reproj_threshold) & mask[None, :] & hyp_ok[:, None]
    best = torch.argmax(torch.sum(inl, dim=-1))

    R_best, t_best = R[best], t[best]
    inl_best = inl[best]
    w = inl_best.to(points2d.dtype)
    rvec, t_ref = _lm_refine(so3_log(R_best), t_best, K, points3d, points2d, w,
                             num_iters=refine_iters)
    R_ref = so3_exp(rvec)

    # Keep the refinement only if it does not lose inliers.
    inl_ref = (_reproj_errors(R_ref, t_ref, K, points3d, points2d) < reproj_threshold) & mask
    keep = torch.sum(inl_ref) >= torch.sum(inl_best)
    R_out = torch.where(keep, R_ref, R_best)
    t_out = torch.where(keep, t_ref, t_best)
    inl_out = torch.where(keep, inl_ref, inl_best)

    ok = (n_valid >= min_points) & (torch.sum(inl_out) >= min_points)
    return PnPResult(R=R_out, t=t_out, inliers=inl_out, num_inliers=torch.sum(inl_out), ok=ok)


@mm_f32
def pnp(
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    refine_iters: int = 15,
    min_points: int = 4,
) -> PnPResult:
    """Non-robust PnP (reference ``PnP``, PoseEstimator.py:71-105): the DLT
    on every valid point with the SVD null vector, then the LM polish;
    inliers are the points under 8 px."""
    n = points3d.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points3d.device)
    w = mask.to(points2d.dtype)
    R, t = _pose_from_projection(_dlt_projection(points3d, points2d, w), K)
    rvec, t = _lm_refine(so3_log(R), t, K, points3d, points2d, w, num_iters=refine_iters)
    R = so3_exp(rvec)
    inl = (_reproj_errors(R, t, K, points3d, points2d) < 8.0) & mask
    ok = torch.sum(mask) >= min_points
    return PnPResult(R=R, t=t, inliers=inl, num_inliers=torch.sum(inl), ok=ok)
