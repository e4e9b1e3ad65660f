"""Distributed bundle adjustment: observations sharded over the ``data``
mesh axis, the normal blocks summed by ``all_reduce`` (counterpart of
``sfmfromscratch_tpu/parallel/sharded_ba.py``).

Each rank holds the whole problem (SPMD), takes its contiguous block of
observations and forms their J^T J contributions (6x6 camera blocks, 3x3
point blocks, per-observation cross terms); every cross-observation sum of
the one LM loop in ``ba/lm_core.py`` is then an ``all_reduce`` over the
axis, so cameras, points, steps and every accept/reject decision are equal
on every rank. The Schur solve runs replicated on the reduced blocks. The
sums add in another order than on one device, so the result agrees with
``ba/lm.py::bundle_adjust`` to float32 rounding, not bit for bit; on a
1-rank axis it is the same bits.

All-reduces per LM iteration: four normal-block sums, the right-hand side,
the point back-substitution and the cost (7), plus two per PCG iteration
(the matvec's two segment sums); the dense path reduces the
per-(point, camera) blocks instead of iterating (8 in all). The selfcal
border adds five (Hss, gs, Wsp, Hsc, q) and its second PCG solve.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from sfmfromscratch_tpu_torch.ba.lm import BAResult, resolve_dense, resolve_forcing
from sfmfromscratch_tpu_torch.ba.lm_core import lm_run
from sfmfromscratch_tpu_torch.ba.problem import BAProblem
from sfmfromscratch_tpu_torch.parallel.mesh import all_reduce_sum, mesh_axis
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

__all__ = ["pad_problem_for_sharding", "bundle_adjust_sharded"]


def pad_problem_for_sharding(problem: BAProblem, num_shards: int) -> BAProblem:
    """Pad the observation arrays to a multiple of ``num_shards`` with
    observations of weight 0, which contribute nothing (``sharded_ba.py:33-48``)."""
    rem = (-problem.num_obs) % num_shards
    if rem == 0:
        return problem
    zi = problem.obs_cam.new_zeros(rem)
    return problem._replace(
        obs_cam=torch.cat([problem.obs_cam, zi]),
        obs_pt=torch.cat([problem.obs_pt, zi]),
        obs_xy=torch.cat([problem.obs_xy, problem.obs_xy.new_zeros((rem, 2))]),
        obs_w=torch.cat([problem.obs_w, problem.obs_w.new_zeros(rem)]),
    )


def bundle_adjust_sharded(
    problem: BAProblem,
    mesh: DeviceMesh,
    axis: str = "data",
    max_iters: int = 30,
    cg_iters: int = 50,
    init_damping: float = 1e-3,
    damping_up: float = 4.0,
    damping_down: float = 0.5,
    ftol: float = 1e-2,
    huber_delta: float = 0.0,
    selfcal: bool = False,
):
    """LM + Schur with this rank's observation shard of ``axis``; cameras and
    points are whole on every rank. ``huber_delta`` is the single-device
    solver's Huber IRLS loss (0 = plain least squares). ``selfcal=True``
    adds the shared focal-scale border (``ba/selfcal.py``), its sums
    reduced like every other block, and returns ``(BAResult, s)``. The
    Schur backend is chosen on the whole problem's counts, before the loop:
    the dense Cholesky only without selfcal and under ``dense_gate``."""
    ax = mesh_axis(mesh, axis)
    if ax is None:
        raise ValueError(f"the mesh has no {axis!r} axis")
    problem = pad_problem_for_sharding(problem, ax.size)
    per = problem.num_obs // ax.size
    lo, hi = ax.rank * per, (ax.rank + 1) * per
    local = problem._replace(obs_cam=problem.obs_cam[lo:hi], obs_pt=problem.obs_pt[lo:hi],
                             obs_xy=problem.obs_xy[lo:hi], obs_w=problem.obs_w[lo:hi])
    use_dense = (not selfcal) and resolve_dense(None, problem.num_cameras, problem.num_points)
    with f32_precision():
        out = lm_run(
            local,
            selfcal=selfcal,
            use_dense=use_dense,
            huber_delta=huber_delta,
            max_iters=max_iters,
            cg_iters=cg_iters,
            init_damping=init_damping,
            damping_up=damping_up,
            damping_down=damping_down,
            ftol=ftol,
            forcing=resolve_forcing(),
            reduce_fn=lambda x: all_reduce_sum(x, ax),
        )
    res = BAResult(
        cam_params=out.cam_params, points=out.points,
        initial_cost=out.initial_cost, final_cost=out.final_cost,
        initial_mean_error=out.initial_mean_error, final_mean_error=out.final_mean_error,
        iterations_used=out.iterations_used,
    )
    return (res, out.s) if selfcal else res
