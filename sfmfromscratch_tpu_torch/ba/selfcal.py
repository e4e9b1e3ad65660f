"""Self-calibrating bundle adjustment: one focal-length scale shared by every
camera, optimised jointly with poses and points (counterpart of
``sfmfromscratch_tpu/ba/selfcal.py``).

Alternating BA with a 1-D focal refit does not work: once BA converges at a
wrong focal, the poses and points absorb the error and its gradient
vanishes. So the scale sits inside the normal equations, as a border on the
Schur-reduced camera system:

    [ h_ss  q^T ] [ds]   [b_s]
    [ q     S   ] [dc] = [b_c]     (points already eliminated)

solved matrix-free with two PCG solves per LM iteration (u = S^-1 b_c,
v = S^-1 q), ds = (b_s - q.u) / (h_ss - q.v), dc = u - ds v, and the point
back-substitution gains a -ds V^-1 Wsp term. The LM loop and the bordered
solve are ``ba/lm_core.py``'s (``selfcal=True``), shared with
``ba/lm.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sfmfromscratch_tpu_torch.ba.lm import BAResult, resolve_forcing
from sfmfromscratch_tpu_torch.ba.lm_core import lm_run
from sfmfromscratch_tpu_torch.ba.problem import BAProblem
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

__all__ = ["bundle_adjust_selfcal"]


def _selfcal_impl(
    problem: BAProblem,
    max_iters: int,
    cg_iters: int,
    init_damping: float,
    damping_up: float,
    damping_down: float,
    ftol: float,
    huber_delta: float,
    forcing: bool,
):
    with f32_precision():
        out = lm_run(
            problem,
            selfcal=True,
            use_dense=False,
            huber_delta=huber_delta,
            max_iters=max_iters,
            cg_iters=cg_iters,
            init_damping=init_damping,
            damping_up=damping_up,
            damping_down=damping_down,
            ftol=ftol,
            forcing=forcing,
        )
    res = BAResult(
        cam_params=out.cam_params, points=out.points,
        initial_cost=out.initial_cost, final_cost=out.final_cost,
        initial_mean_error=out.initial_mean_error,
        final_mean_error=out.final_mean_error,
        iterations_used=out.iterations_used,
    )
    return res, out.s


def bundle_adjust_selfcal(
    problem: BAProblem,
    max_iters: int = 30,
    cg_iters: int = 50,
    init_damping: float = 1e-3,
    damping_up: float = 4.0,
    damping_down: float = 0.5,
    ftol: float = 1e-2,
    huber_delta: float = 0.0,
) -> Tuple[BAResult, torch.Tensor]:
    """LM over (focal scale, cameras, points), in float32 with TF32 off.
    Returns (BAResult, s), ``s`` a 0-dim tensor on the problem's device."""
    return _selfcal_impl(
        problem, max_iters, cg_iters, init_damping, damping_up, damping_down,
        ftol, huber_delta, resolve_forcing(),
    )
