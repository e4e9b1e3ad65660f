"""Two-view relative-pose refinement: batched Sampson-error Gauss-Newton
(counterpart of ``sfmfromscratch_tpu/geometry/two_view.py``).

The 5-dof pose moves as ``R <- exp(w) R`` and ``t`` in its 2-dof tangent
basis, renormalised; the residual is the Sampson distance; each damped GN
step solves a 5x5 system per edge with accept/reject. The residual Jacobian
comes from ``torch.func.jacfwd`` over the 5 parameters, vmapped over edges
as the JAX package vmaps its ``jacfwd``. The JAX ``lax.scan`` over steps is
a Python loop with no host read.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sfmfromscratch_tpu_torch.ops.lie import so3_exp, so3_hat
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


def _tangent_basis(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two unit vectors orthogonal to t (and each other); the cross product
    is taken with the axis least aligned with t."""
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    ax = torch.where(torch.abs(t[..., 0:1]) < 0.9, x_axis, y_axis)
    e1 = torch.linalg.cross(t, ax)
    e1 = e1 / torch.clamp_min(torch.linalg.norm(e1, dim=-1, keepdim=True), 1e-12)
    e2 = torch.linalg.cross(t, e1)
    e2 = e2 / torch.clamp_min(torch.linalg.norm(e2, dim=-1, keepdim=True), 1e-12)
    return e1, e2


def _sampson_residuals(
    R: torch.Tensor, t: torch.Tensor,
    p1: torch.Tensor, p2: torch.Tensor,
    K1i: torch.Tensor, K2i: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Masked Sampson distances (N,) for pixel correspondences."""
    F = K2i.T @ (so3_hat(t) @ R) @ K1i
    x1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    x2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=1)
    Fx1 = x1 @ F.T
    Ftx2 = x2 @ F
    num = torch.sum(x2 * Fx1, dim=1)
    den = torch.sqrt(Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)
    return mask * num / torch.clamp_min(den, 1e-12)


def _params_to_pose(R, t, dp):
    # Slices, not 0-dim elements: jacfwd promotes a 0-dim tangent met by a
    # Python scalar to float64.
    Rn = so3_exp(dp[:3]) @ R
    e1, e2 = _tangent_basis(t)
    tn = t + dp[3:4] * e1 + dp[4:5] * e2
    return Rn, tn / torch.clamp_min(torch.linalg.norm(tn, dim=-1, keepdim=True), 1e-12)


def _gn_step(R, t, lm, p1, p2, K1i, K2i, mf, has_data):
    """One damped GN step of one edge."""
    def res_fn(dp):
        return _sampson_residuals(*_params_to_pose(R, t, dp), p1, p2, K1i, K2i, mf)

    dp0 = torch.zeros(5, dtype=p1.dtype, device=p1.device)
    r = res_fn(dp0)
    J = torch.func.jacfwd(res_fn)(dp0)                      # (N, 5)
    JtJ = J.T @ J
    g = J.T @ r
    A = JtJ + lm * torch.diag(torch.clamp_min(torch.diagonal(JtJ), 1e-8))
    dp = -torch.linalg.solve(A, g)
    R_new, t_new = _params_to_pose(R, t, dp)
    r_new = _sampson_residuals(R_new, t_new, p1, p2, K1i, K2i, mf)
    better = (torch.sum(r_new * r_new) < torch.sum(r * r)) & has_data
    R = torch.where(better, R_new, R)
    t = torch.where(better, t_new, t)
    lm = torch.clamp(torch.where(better, lm * 0.3, lm * 4.0), 1e-8, 1e6)
    return R, t, lm


_gn_step_edges = torch.func.vmap(_gn_step)


@mm_f32
def refine_relative_pose(
    R0: torch.Tensor,      # (E, 3, 3)
    t0: torch.Tensor,      # (E, 3) unit
    p1: torch.Tensor,      # (E, N, 2)
    p2: torch.Tensor,      # (E, N, 2)
    K1: torch.Tensor,      # (E, 3, 3)
    K2: torch.Tensor,      # (E, 3, 3)
    mask: torch.Tensor,    # (E, N) bool/float inlier weights
    num_iters: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched damped-GN Sampson refinement (two_view.py:73-134). Returns
    ``(R, t, rms)``, ``rms`` the final masked Sampson RMS per edge (px). An
    edge with fewer than 5 weighted correspondences passes through
    unchanged."""
    K1i = torch.linalg.inv(K1)
    K2i = torch.linalg.inv(K2)
    mf = mask.to(p1.dtype)
    n_eff = torch.clamp_min(torch.sum(mf, dim=-1), 1.0)
    has_data = torch.sum(mf, dim=-1) >= 5
    R, t = R0, t0
    lm = torch.full(R0.shape[:1], 1e-3, dtype=p1.dtype, device=p1.device)
    for _ in range(num_iters):
        R, t, lm = _gn_step_edges(R, t, lm, p1, p2, K1i, K2i, mf, has_data)
    r = torch.func.vmap(_sampson_residuals)(R, t, p1, p2, K1i, K2i, mf)
    rms = torch.sqrt(torch.sum(r * r, dim=-1) / n_eff)
    return R, t, rms
