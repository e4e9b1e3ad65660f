"""The Levenberg-Marquardt loop of bundle adjustment
(counterpart of ``sfmfromscratch_tpu/ba/lm_core.py``, without the
self-calibration border).

Each iteration: analytic Jacobian blocks, damped normal blocks, a Schur
solve (exact dense Cholesky or PCG with Eisenstat-Walker forcing), then the
step is accepted when the cost falls and the damping adapts. The JAX
``while_loop`` becomes a Python loop with one host read per iteration (the
``done`` flag). Kept exactly as written there: the first forcing eta of
0.15, and the rule that only a tightly solved step (eta at its floor, or the
exact dense solve) may end the solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfmfromscratch_tpu_torch.ba.problem import BAProblem, jacobian_blocks, residuals, total_cost
from sfmfromscratch_tpu_torch.ba.schur import build_normal_blocks, solve_schur, solve_schur_dense

__all__ = ["LMRunOut", "lm_run", "robust_cost", "huber_weights"]


def robust_cost(problem: BAProblem, cam: torch.Tensor, pts: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber cost over per-observation residual norms (delta <= 0 => plain
    least squares)."""
    r = residuals(problem, cam, pts)
    if delta <= 0:
        return torch.sum(r * r)
    rn = torch.linalg.norm(r, dim=-1)
    return torch.sum(torch.where(rn <= delta, rn * rn, 2.0 * delta * rn - delta * delta))


def huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """(O,) IRLS scale factors sqrt(rho'(|r|)/|r|), 1 inside the quadratic zone."""
    rn = torch.linalg.norm(r, dim=-1)
    return torch.where(rn <= delta, 1.0, torch.sqrt(delta / torch.clamp_min(rn, 1e-12)))


class LMRunOut(NamedTuple):
    cam_params: torch.Tensor   # (C, 6)
    points: torch.Tensor       # (P, 3)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    initial_mean_error: torch.Tensor
    final_mean_error: torch.Tensor
    iterations_used: int


def _mean_err(p: BAProblem, cam: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    r = residuals(p, cam, pts)
    w = p.obs_w
    err = torch.linalg.norm(r, dim=-1) / torch.clamp_min(w, 1e-12)
    err = torch.where(w > 0, err, 0.0)
    n = torch.sum((w > 0).to(r.dtype))
    return torch.sum(err) / torch.clamp_min(n, 1.0)


def lm_run(
    base: BAProblem,
    *,
    use_dense: bool,
    huber_delta: float,
    max_iters: int,
    cg_iters: int,
    init_damping: float,
    damping_up: float,
    damping_down: float,
    ftol: float,
    forcing: bool = True,
) -> LMRunOut:
    """Run LM from ``base``'s cameras and points to convergence (a tightly
    solved accepted step with relative cost decrease < ``ftol``) or
    ``max_iters``."""
    C = base.num_cameras
    Pn = base.num_points
    dtype = base.points.dtype
    dev = base.points.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def cost_fn(cam, pts):
        if huber_delta > 0:
            return robust_cost(base, cam, pts, huber_delta)
        return total_cost(base, cam, pts)

    cam, pts = base.cam_params, base.points
    cost0 = cost_fn(cam, pts)
    err0 = _mean_err(base, cam, pts)
    lam = scalar(init_damping)
    cost = cost0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eta = scalar(0.15 if forcing else 0.0)
    it = 0
    while it < max_iters and not bool(done):
        eta_used = eta
        Jc, Jp, r = jacobian_blocks(base, cam, pts)
        if huber_delta > 0:
            hw = huber_weights(r, huber_delta)
            r = r * hw[:, None]
            Jc = Jc * hw[:, None, None]
            Jp = Jp * hw[:, None, None]
        op = build_normal_blocks(Jc, Jp, r, base.obs_cam, base.obs_pt, C, Pn, lam)
        if use_dense:
            dc, dp = solve_schur_dense(op)
            eta_used = torch.zeros_like(eta)   # exact solve: always "tight"
        else:
            dc, dp = solve_schur(op, cg_iters=cg_iters, tol_rel=eta)

        dc = torch.where(base.cam_fixed[:, None], 0.0, dc)
        cam_new = cam - dc
        pts_new = pts - dp
        new_cost = cost_fn(cam_new, pts_new)
        improved = (new_cost < cost) & torch.isfinite(new_cost)

        cam = torch.where(improved, cam_new, cam)
        pts = torch.where(improved, pts_new, pts)
        lam = torch.where(improved, lam * damping_down, lam * damping_up)
        rel_decrease = (cost - new_cost) / torch.clamp_min(cost, 1e-20)
        # Only a tightly solved step may declare convergence (lm_core.py:248-254).
        done = done | (improved & (rel_decrease < ftol) & (eta_used <= 2e-3))
        cost = torch.where(improved, new_cost, cost)
        # Eisenstat-Walker forcing, bounded to [1e-3, 0.3] (lm_core.py:256-270).
        if forcing:
            eta = torch.where(
                improved,
                torch.clamp(torch.sqrt(torch.clamp_min(rel_decrease, 0.0)), 1e-3, 0.3),
                scalar(1e-3),
            )
        else:
            eta = torch.zeros_like(eta)
        it += 1
    return LMRunOut(
        cam_params=cam, points=pts,
        initial_cost=cost0, final_cost=cost,
        initial_mean_error=err0, final_mean_error=_mean_err(base, cam, pts),
        iterations_used=it,
    )
