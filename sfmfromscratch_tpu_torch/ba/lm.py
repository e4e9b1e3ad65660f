"""Levenberg-Marquardt bundle adjustment on the device
(counterpart of ``sfmfromscratch_tpu/ba/lm.py``).

This module chooses the Schur backend (the dense gate and its environment
override, as the JAX package resolves them) and wraps the result of the one
LM loop in ``ba/lm_core.py``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from sfmfromscratch_tpu_torch.ba.lm_core import huber_weights, lm_run, robust_cost  # noqa: F401
from sfmfromscratch_tpu_torch.ba.problem import BAProblem
from sfmfromscratch_tpu_torch.ba.schur import dense_gate
from sfmfromscratch_tpu_torch.utils.precision import f32_precision


class BAResult(NamedTuple):
    cam_params: torch.Tensor     # (C, 6) optimized [rvec | t]
    points: torch.Tensor         # (P, 3) optimized points
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    initial_mean_error: torch.Tensor
    final_mean_error: torch.Tensor
    iterations_used: int


def resolve_dense(use_dense: Optional[bool], num_cameras: int, num_points: int) -> bool:
    """Schur backend: explicit choice > ``SFM_NO_DENSE_SCHUR`` > ``dense_gate``."""
    if use_dense is not None:
        return bool(use_dense)
    if os.environ.get("SFM_NO_DENSE_SCHUR"):
        return False
    return dense_gate(num_cameras, num_points)


def resolve_forcing() -> bool:
    """Eisenstat-Walker forcing unless ``SFM_NO_CG_FORCING`` is set."""
    return not os.environ.get("SFM_NO_CG_FORCING")


def bundle_adjust(
    problem: BAProblem,
    max_iters: int = 30,
    cg_iters: int = 50,
    init_damping: float = 1e-3,
    damping_up: float = 4.0,
    damping_down: float = 0.5,
    ftol: float = 1e-2,
    huber_delta: float = 0.0,
    use_dense: Optional[bool] = None,
) -> BAResult:
    """Run LM to convergence (relative cost decrease < ftol on a tightly
    solved step) or ``max_iters``, in float32 with TF32 off.

    ``huber_delta > 0`` switches to a Huber loss by IRLS. ``use_dense``
    picks the Schur backend (None = dense Cholesky when ``dense_gate``
    passes on the problem's counts, PCG otherwise); both solve the same
    normal equations.
    """
    with f32_precision():
        out = lm_run(
            problem,
            use_dense=resolve_dense(use_dense, problem.num_cameras, problem.num_points),
            huber_delta=huber_delta,
            max_iters=max_iters,
            cg_iters=cg_iters,
            init_damping=init_damping,
            damping_up=damping_up,
            damping_down=damping_down,
            ftol=ftol,
            forcing=resolve_forcing(),
        )
    return BAResult(
        cam_params=out.cam_params,
        points=out.points,
        initial_cost=out.initial_cost,
        final_cost=out.final_cost,
        initial_mean_error=out.initial_mean_error,
        final_mean_error=out.final_mean_error,
        iterations_used=out.iterations_used,
    )
