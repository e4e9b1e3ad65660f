"""Bundle-adjustment problem container and residual/Jacobian machinery
(counterpart of ``sfmfromscratch_tpu/ba/problem.py``).

The problem is a NamedTuple of fixed-shape tensors. The per-observation 2x6
camera and 2x3 point Jacobian blocks come from forward-mode AD through
``so3_exp`` (``torch.func.jacfwd`` vmapped over observations, as the JAX
package's vmapped ``jvp``): analytic, batched, on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ops.lie import so3_exp


class BAProblem(NamedTuple):
    """Fixed-shape sparse BA problem.

    cam_params: (C, 6) [rvec | t] world-to-camera
    points:     (P, 3) world points
    K:          (C, 3, 3) per-camera intrinsics
    obs_cam:    (O,) int64 camera index per observation
    obs_pt:     (O,) int64 point index per observation
    obs_xy:     (O, 2) observed pixels
    obs_w:      (O,) float32 observation weight (0 = padding/invalid)
    cam_fixed:  (C,) bool, cameras frozen during optimization
    pt_fixed:   (P,) bool or None, points frozen during optimization
    """

    cam_params: torch.Tensor
    points: torch.Tensor
    K: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_xy: torch.Tensor
    obs_w: torch.Tensor
    cam_fixed: torch.Tensor
    pt_fixed: Optional[torch.Tensor] = None

    @property
    def num_cameras(self) -> int:
        return self.cam_params.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_obs(self) -> int:
        return self.obs_cam.shape[0]


def make_problem(
    camera_params,
    points_3d,
    camera_indices,
    point_indices,
    points_2d,
    K_list,
    obs_weights=None,
    cam_fixed=None,
    pt_fixed=None,
    dtype=torch.float32,
    device="cpu",
) -> BAProblem:
    """Build a BAProblem on ``device`` from reference-layout host arrays."""
    O = len(camera_indices)
    if obs_weights is None:
        obs_weights = np.ones(O, dtype=np.float32)
    C = np.shape(camera_params)[0]
    if cam_fixed is None:
        cam_fixed = np.zeros(C, dtype=bool)

    def t(a, dt):
        # np.array copies: arrays handed over by JAX are read-only.
        return torch.as_tensor(np.array(a), device=device).to(dt)

    return BAProblem(
        cam_params=t(camera_params, dtype),
        points=t(points_3d, dtype).reshape(-1, 3),
        K=t(K_list, dtype).reshape(-1, 3, 3),
        obs_cam=t(camera_indices, torch.int64),
        obs_pt=t(point_indices, torch.int64),
        obs_xy=t(points_2d, dtype).reshape(-1, 2),
        obs_w=t(obs_weights, dtype),
        cam_fixed=t(cam_fixed, torch.bool),
        pt_fixed=None if pt_fixed is None else t(pt_fixed, torch.bool),
    )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_problem(
    problem: BAProblem,
    cam_bucket: int = 8,
    point_bucket: int = 1024,
    obs_bucket: int = 4096,
) -> BAProblem:
    """Pad cameras/points/observations up to the JAX package's bucketed
    capacities. Padded cameras are frozen and unobserved, padded
    observations carry zero weight, so they contribute nothing. The port
    compiles nothing per shape; it pads because the Schur backend is chosen
    on the padded counts (``dense_gate``), as in the JAX package."""
    C, P, O = problem.num_cameras, problem.num_points, problem.num_obs
    Cp = _round_up(max(C, 1), cam_bucket)
    Pp = _round_up(max(P, 1), point_bucket)
    Op = _round_up(max(O, 1), obs_bucket)
    if (Cp, Pp, Op) == (C, P, O):
        return problem

    def pad(arr, n, fill=0):
        extra = arr.new_full((n - arr.shape[0],) + tuple(arr.shape[1:]), fill)
        return torch.cat([arr, extra])

    eyeK = torch.eye(3, dtype=problem.K.dtype, device=problem.K.device).expand(Cp - C, 3, 3)
    return BAProblem(
        cam_params=pad(problem.cam_params, Cp),
        points=pad(problem.points, Pp),
        K=torch.cat([problem.K, eyeK]),
        obs_cam=pad(problem.obs_cam, Op),
        obs_pt=pad(problem.obs_pt, Op),
        obs_xy=pad(problem.obs_xy, Op),
        obs_w=pad(problem.obs_w, Op),
        cam_fixed=pad(problem.cam_fixed, Cp, True),
        pt_fixed=None if problem.pt_fixed is None else pad(problem.pt_fixed, Pp, True),
    )


def _project(cam: torch.Tensor, X: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project points through cameras ([rvec | t] 6-vectors); leading
    dimensions broadcast (reference SFM.py:437-440, 448-462)."""
    R = so3_exp(cam[..., :3])
    t = cam[..., 3:]
    p = [R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1] + R[..., i, 2] * X[..., 2]
         + t[..., i] for i in range(3)]
    h = [K[..., i, 0] * p[0] + K[..., i, 1] * p[1] + K[..., i, 2] * p[2] for i in range(3)]
    z = torch.where(torch.abs(h[2]) < 1e-12, 1e-12, h[2])
    return torch.stack([h[0] / z, h[1] / z], dim=-1)


def residuals(problem: BAProblem, cam_params: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(O, 2) weighted reprojection residuals (projected - observed)."""
    proj = _project(cam_params[problem.obs_cam], points[problem.obs_pt], problem.K[problem.obs_cam])
    return (proj - problem.obs_xy) * problem.obs_w[:, None]


def total_cost(problem: BAProblem, cam_params: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    r = residuals(problem, cam_params, points)
    return torch.sum(r * r)


def mean_reprojection_error(
    problem: BAProblem, cam_params: Optional[torch.Tensor] = None,
    points: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean per-observation pixel error over the weighted observations."""
    cam_params = problem.cam_params if cam_params is None else cam_params
    points = problem.points if points is None else points
    r = residuals(problem, cam_params, points)
    w = problem.obs_w
    err = torch.linalg.norm(r, dim=-1) / torch.clamp_min(w, 1e-12)
    err = torch.where(w > 0, err, 0.0)
    return torch.sum(err) / torch.clamp_min(torch.sum(w > 0), 1)


def jacobian_blocks(problem: BAProblem, cam_params: torch.Tensor, points: torch.Tensor):
    """Per-observation Jacobian blocks by forward-mode AD.

    Returns (Jc (O, 2, 6), Jp (O, 2, 3), r (O, 2)). One sweep per
    observation over the concatenated 9-vector [cam | X] gives the residual
    and all nine columns. Fixed cameras get zero camera blocks, fixed points
    zero point blocks.
    """
    z = torch.cat([cam_params[problem.obs_cam], points[problem.obs_pt]], dim=-1)   # (O, 9)
    Ks = problem.K[problem.obs_cam]

    def f(zz, K, xy, w):
        out = (_project(zz[:6], zz[6:], K) - xy) * w
        return out, out

    J, r = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(z, Ks, problem.obs_xy, problem.obs_w)
    Jc, Jp = J[..., :6], J[..., 6:]
    fixed = problem.cam_fixed[problem.obs_cam]
    Jc = torch.where(fixed[:, None, None], 0.0, Jc)
    if problem.pt_fixed is not None:
        pfix = problem.pt_fixed[problem.obs_pt]
        Jp = torch.where(pfix[:, None, None], 0.0, Jp)
    return Jc, Jp, r
