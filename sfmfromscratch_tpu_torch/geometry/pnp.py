"""Perspective-n-Point pose estimation: P3P hypotheses + RANSAC + a
Levenberg-Marquardt polish (counterpart of ``sfmfromscratch_tpu/geometry/pnp.py``).

Replaces the reference's ``cv2.solvePnPRansac`` (PoseEstimator.py:32-69):
every P3P hypothesis of the sample batch is scored at once by reprojection
error, the winner is polished by fixed-iteration LM over (so3, t) on its
inliers with the Jacobian from forward-mode AD through ``so3_exp``
(``torch.func.jacfwd``, as ``jax.jacfwd`` there). Only ``solver="p3p"`` is
ported; the 6-point DLT generator and ``pnp`` are not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sfmfromscratch_tpu_torch.geometry.p3p import p3p_poses
from sfmfromscratch_tpu_torch.geometry.ransac import draw_uniforms, uniforms_to_indices
from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_log
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class PnPResult(NamedTuple):
    R: torch.Tensor            # (3, 3)
    t: torch.Tensor            # (3,)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # ()
    ok: torch.Tensor           # () bool: enough support to trust the pose


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

    3-point samples, up to 4 Grunert poses each, scored by reprojection
    error under ``reproj_threshold``; the winner is LM-polished on its
    inliers and the polish is kept unless it loses inliers. Returns
    world-to-camera (R, t); ``ok`` is False below ``min_points`` of support.
    ``uniforms`` (num_hypotheses, 3) replaces the draw from ``generator``.
    """
    if solver != "p3p":
        raise NotImplementedError(f"pnp_ransac solver {solver!r}: only 'p3p' is ported")
    n = points3d.shape[0]
    dev = points3d.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    n_valid = torch.sum(mask)
    sample_size = 3 if sample_size is None else sample_size

    if uniforms is None:
        uniforms = draw_uniforms(generator, num_hypotheses, sample_size, dev)
    idx = uniforms_to_indices(uniforms.to(dev), n, mask, sample_size)
    Rh, th, vh = p3p_poses(points3d[idx], points2d[idx], K)  # (B, 4, ...)
    R = Rh.reshape(-1, 3, 3)                                 # (4B, 3, 3)
    t = th.reshape(-1, 3)
    hyp_ok = vh.reshape(-1)

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
