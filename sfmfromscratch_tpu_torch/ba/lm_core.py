"""The Levenberg-Marquardt loop of bundle adjustment
(counterpart of ``sfmfromscratch_tpu/ba/lm_core.py``).

Each iteration: analytic Jacobian blocks, damped normal blocks, a Schur
solve (exact dense Cholesky or PCG with Eisenstat-Walker forcing), then the
step is accepted when the cost falls and the damping adapts. The JAX
``while_loop`` becomes a Python loop with one host read per iteration (the
``done`` flag). Kept exactly as written there: the first forcing eta of
0.15, and the rule that only a tightly solved step (eta at its floor, or the
exact dense solve) may end the solve.

``selfcal=True`` adds one shared focal scale ``s`` to the unknowns: a border
on the Schur-reduced camera system, solved by two PCG solves on the same
operator (``ba/selfcal.py`` has the algebra). It has no dense path.

``reduce_fn`` (None: the identity) reduces every cross-observation sum: the
cost, the mean error's numerator and count, the normal blocks and the
selfcal border. ``parallel/sharded_ba.py`` runs this loop on each rank's
observation shard with an ``all_reduce``; the reduced values are equal on
every rank, so every rank takes the same accept/reject and stop decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfmfromscratch_tpu_torch.ba.problem import BAProblem, jacobian_blocks, residuals, total_cost
from sfmfromscratch_tpu_torch.ba.schur import (
    back_substitute_points,
    build_normal_blocks,
    conjugate_gradient,
    schur_matvec,
    schur_rhs,
    segment_sum,
    solve_schur,
    solve_schur_dense,
)
from sfmfromscratch_tpu_torch.utils import profiling
from sfmfromscratch_tpu_torch.utils.precision import mm_f32

__all__ = ["LMRunOut", "lm_run", "robust_cost", "huber_weights", "scale_focal"]


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


def scale_focal(problem: BAProblem, s: torch.Tensor) -> BAProblem:
    """Problem with fx, fy scaled by the shared self-calibration factor ``s``."""
    K = problem.K.clone()
    K[:, 0, 0] = K[:, 0, 0] * s
    K[:, 1, 1] = K[:, 1, 1] * s
    return problem._replace(K=K)


class LMRunOut(NamedTuple):
    cam_params: torch.Tensor   # (C, 6)
    points: torch.Tensor       # (P, 3)
    s: torch.Tensor            # () focal scale (1.0 unless selfcal)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    initial_mean_error: torch.Tensor
    final_mean_error: torch.Tensor
    iterations_used: int


def _mean_err(p: BAProblem, cam: torch.Tensor, pts: torch.Tensor, red) -> torch.Tensor:
    r = residuals(p, cam, pts)
    w = p.obs_w
    err = torch.linalg.norm(r, dim=-1) / torch.clamp_min(w, 1e-12)
    err = torch.where(w > 0, err, 0.0)
    n = red(torch.sum((w > 0).to(r.dtype)))
    return red(torch.sum(err)) / torch.clamp_min(n, 1.0)


def _selfcal_border_jacobian(base: BAProblem, p_s: BAProblem, r: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """(O, 2) d r / d s, analytically: r = w (proj - obs) and
    d proj / d s = (proj - principal point) / s."""
    w = base.obs_w
    valid = (w > 0)[:, None]
    proj = torch.where(valid, r / torch.clamp_min(w, 1e-12)[:, None], 0.0) + base.obs_xy
    pp = p_s.K[base.obs_cam][:, :2, 2]
    return torch.where(valid, (proj - pp) / s * w[:, None], 0.0)


@mm_f32
def _solve_bordered(op, Js, Jc, Jp, r, lam, cg_iters, eta, cam_fixed, red=None):
    """Bordered Schur solve of the selfcal system (points already
    eliminated): two PCG solves on the same operator, u = S^-1 b_c and
    v = S^-1 q, then ds = (b_s - q.u) / (h_ss - q.v) and dc = u - ds v.
    Frozen cameras' steps are zeroed before the point back-substitution, so
    the points back-substitute the camera step that is applied. ``red``
    reduces the border's sums (Hss, gs, Wsp, Hsc, q) as the normal blocks."""
    red = red or (lambda x: x)
    C = op.U.shape[0]
    Pn = op.Vinv.shape[0]
    eps = 1e-8
    Hss = red(torch.sum(Js * Js))
    Hss_d = Hss * (1.0 + lam) + eps
    gs = red(torch.sum(Js * r))
    Wsp = red(segment_sum(torch.einsum("ok,okj->oj", Js, Jp), op.obs_pt, Pn))  # (P, 3)
    Hsc = red(segment_sum(torch.einsum("ok,oki->oi", Js, Jc), op.obs_cam, C))  # (C, 6)
    VinvWsp = torch.einsum("pij,pj->pi", op.Vinv, Wsp)                         # (P, 3)
    d_o = torch.einsum("oij,oj->oi", op.W, VinvWsp[op.obs_pt])
    q = Hsc - red(segment_sum(d_o, op.obs_cam, C))
    hss_red = Hss_d - torch.sum(Wsp * VinvWsp)
    b_s = gs - torch.sum(Wsp * torch.einsum("pij,pj->pi", op.Vinv, op.gp))

    b_c = schur_rhs(op, red)
    Uinv = torch.linalg.inv_ex(op.U)[0]

    def mv(x):
        return schur_matvec(op, x.reshape(C, 6), red).reshape(-1)

    def pc(x):
        return torch.einsum("cij,cj->ci", Uinv, x.reshape(C, 6)).reshape(-1)

    u = conjugate_gradient(mv, b_c.reshape(-1), cg_iters, precond=pc, tol_rel=eta)
    v = conjugate_gradient(mv, q.reshape(-1), cg_iters, precond=pc, tol_rel=eta)
    qf = q.reshape(-1)
    denom = hss_red - torch.dot(qf, v)
    ds = (b_s - torch.dot(qf, u)) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    dc = (u - ds * v).reshape(C, 6)
    dc = torch.where(cam_fixed[:, None], 0.0, dc)
    dp = back_substitute_points(op, dc, red) - ds * VinvWsp
    return dc, dp, ds


def lm_run(
    base: BAProblem,
    *,
    selfcal: bool = False,
    use_dense: bool,
    huber_delta: float,
    max_iters: int,
    cg_iters: int,
    init_damping: float,
    damping_up: float,
    damping_down: float,
    ftol: float,
    forcing: bool = True,
    reduce_fn=None,
) -> LMRunOut:
    """Run LM from ``base``'s cameras and points to convergence (a tightly
    solved accepted step with relative cost decrease < ``ftol``) or
    ``max_iters``; with ``selfcal`` the shared focal scale moves too,
    clipped to [0.5, 2]. ``base``'s observation arrays may be a shard of
    the problem's, with ``reduce_fn`` summing over the shards; cameras,
    points and K are whole on every shard. Each iteration adds 1 to the
    counter ``lm_iters`` of the innermost open span (``profiling.count``)."""
    if selfcal and use_dense:
        raise ValueError("the bordered selfcal solve has no dense path")
    red = reduce_fn or (lambda x: x)
    C = base.num_cameras
    Pn = base.num_points
    dtype = base.points.dtype
    dev = base.points.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def scaled(s):
        return scale_focal(base, s) if selfcal else base

    def cost_fn(cam, pts, s):
        p = scaled(s)
        if huber_delta > 0:
            return red(robust_cost(p, cam, pts, huber_delta))
        return red(total_cost(p, cam, pts))

    cam, pts = base.cam_params, base.points
    s = scalar(1.0)
    cost0 = cost_fn(cam, pts, s)
    err0 = _mean_err(scaled(s), cam, pts, red)
    lam = scalar(init_damping)
    cost = cost0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eta = scalar(0.15 if forcing else 0.0)
    it = 0
    while it < max_iters and not bool(done):
        profiling.count("lm_iters")
        eta_used = eta
        p_s = scaled(s)
        Jc, Jp, r = jacobian_blocks(p_s, cam, pts)
        if selfcal:
            Js = _selfcal_border_jacobian(base, p_s, r, s)
        if huber_delta > 0:
            hw = huber_weights(r, huber_delta)
            r = r * hw[:, None]
            Jc = Jc * hw[:, None, None]
            Jp = Jp * hw[:, None, None]
            if selfcal:
                Js = Js * hw[:, None]
        op = build_normal_blocks(Jc, Jp, r, base.obs_cam, base.obs_pt, C, Pn, lam, red)
        if selfcal:
            dc, dp, ds = _solve_bordered(op, Js, Jc, Jp, r, lam, cg_iters, eta, base.cam_fixed,
                                         red)
        elif use_dense:
            dc, dp = solve_schur_dense(op, red)
            eta_used = torch.zeros_like(eta)   # exact solve: always "tight"
        else:
            dc, dp = solve_schur(op, cg_iters=cg_iters, tol_rel=eta, reduce_fn=red)

        dc = torch.where(base.cam_fixed[:, None], 0.0, dc)
        cam_new = cam - dc
        pts_new = pts - dp
        s_new = torch.clamp(s - ds, 0.5, 2.0) if selfcal else s
        new_cost = cost_fn(cam_new, pts_new, s_new)
        improved = (new_cost < cost) & torch.isfinite(new_cost)

        cam = torch.where(improved, cam_new, cam)
        pts = torch.where(improved, pts_new, pts)
        s = torch.where(improved, s_new, s)
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
        cam_params=cam, points=pts, s=s,
        initial_cost=cost0, final_cost=cost,
        initial_mean_error=err0, final_mean_error=_mean_err(scaled(s), cam, pts, red),
        iterations_used=it,
    )
