"""SO(3) exponential/logarithm maps (counterpart of ``sfmfromscratch_tpu/ops/lie.py``).

Closed-form and batched over leading dimensions; the JAX ``lax.switch`` of
the near-pi branch becomes a gather of the per-anchor candidates.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation, with
    Taylor expansions of sin(t)/t and (1-cos t)/t^2 near t = 0."""
    # keepdim: forward-mode AD (torch.func.jacfwd) promotes the tangent of a
    # 0-dim tensor combined with a Python scalar to float64.
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_safe)) / theta2_safe)
    K = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe at the identity;
    near theta = pi it uses the largest-diagonal-axis extraction."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * torch.clamp_min(sin_t, _EPS)))
    w_generic = scale[..., None] * v

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp_min((diag + 1.0) * 0.5, 0.0)
    axis = torch.sqrt(axis2)
    k = torch.argmax(axis2, dim=-1)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
    cands = torch.stack(
        [
            torch.stack([a0, s01 * a1, s02 * a2], dim=-1),   # anchor x
            torch.stack([s01 * a0, a1, s12 * a2], dim=-1),   # anchor y
            torch.stack([s02 * a0, s12 * a1, a2], dim=-1),   # anchor z
        ],
        dim=-2,
    )                                                        # (..., 3, 3)
    idx = k[..., None, None].expand(k.shape + (1, 3))
    axis_fixed = torch.gather(cands, -2, idx)[..., 0, :]

    w_pi = theta[..., None] * axis_fixed
    near_pi = theta > math.pi - 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)
