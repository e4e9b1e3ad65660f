"""Closed-form P3P minimal solver (Grunert), batched
(counterpart of ``sfmfromscratch_tpu/geometry/p3p.py``).

Grunert's distance equations reduce to a quartic in the distance ratio
v = s3/s1, assembled from small polynomial products and solved in closed form
(Ferrari with a trigonometric/Cardano resolvent cubic), then polished by
Newton steps. Each real root gives camera-frame distances; the absolute
orientation is the closed-form polar Newton iteration of ``_kabsch`` (no
SVD, as the JAX package places it). Every sample yields up to 4 poses with a
validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sfmfromscratch_tpu_torch.ops.smallsvd import inv3
from sfmfromscratch_tpu_torch.utils.precision import mm_f32

_EPS = 1e-12


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (``jnp.cbrt``): torch has none."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _solve_cubic_largest(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Largest real root of x^3 + a x^2 + b x + c (batched, closed form):
    trigonometric method with three real roots, Cardano with one, both
    computed and selected with ``where``."""
    P = b - a * a / 3.0
    Q = 2.0 * a * a * a / 27.0 - a * b / 3.0 + c
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    s_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)

    Pn = torch.clamp_max(P, -_EPS)
    rho = torch.sqrt(-Pn / 3.0)
    arg = 3.0 * Q / (2.0 * Pn) * torch.sqrt(-3.0 / Pn)
    phi = torch.arccos(torch.clamp(arg, -1.0, 1.0))
    s_trig = 2.0 * rho * torch.cos(phi / 3.0)

    s = torch.where(disc > 0.0, s_card, s_trig)
    return s - a / 3.0


def quartic_roots(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0.

    ``coeffs``: (..., 5) ordered [c4, c3, c2, c1, c0]. Returns
    ``(roots (..., 4), valid (..., 4))``; invalid slots hold 0. Closed form
    (Ferrari) + 6 Newton steps on the original quartic.
    """
    c4, c3, c2, c1, c0 = (coeffs[..., i] for i in range(5))
    scale = torch.max(torch.abs(coeffs), dim=-1).values
    ok_lead = torch.abs(c4) > 1e-9 * torch.clamp_min(scale, _EPS)
    c4s = torch.where(ok_lead, c4, 1.0)
    p3 = c3 / c4s
    p2 = c2 / c4s
    p1 = c1 / c4s
    p0 = c0 / c4s

    # Depressed quartic y^4 + p y^2 + q y + r,  x = y - p3/4.
    e = p3 / 4.0
    p = p2 - 3.0 * e * e * 2.0
    q = p1 - p3 * p2 / 2.0 + p3 * p3 * p3 / 8.0
    r = p0 - p3 * p1 / 4.0 + p3 * p3 * p2 / 16.0 - 3.0 * ((p3 * p3) * (p3 * p3)) / 256.0

    # Resolvent cubic in w = m^2:  w^3 + 2p w^2 + (p^2 - 4r) w - q^2 = 0.
    w = _solve_cubic_largest(2.0 * p, p * p - 4.0 * r, -q * q)
    w = torch.clamp_min(w, 0.0)
    m = torch.sqrt(w)

    biquad = m < 1e-6
    m_safe = torch.where(biquad, 1.0, m)

    S = (p + w - q / m_safe) / 2.0
    T = (p + w + q / m_safe) / 2.0
    d1 = m * m - 4.0 * S
    d2 = m * m - 4.0 * T
    # Marginally negative discriminants from float32 cancellation still
    # yield a root that Newton polishes onto the near-double root.
    tol1 = 1e-3 * (m * m + torch.abs(4.0 * S)) + 1e-9
    tol2 = 1e-3 * (m * m + torch.abs(4.0 * T)) + 1e-9
    sd1 = torch.sqrt(torch.clamp_min(d1, 0.0))
    sd2 = torch.sqrt(torch.clamp_min(d2, 0.0))
    roots_f = torch.stack(
        [(-m + sd1) / 2.0, (-m - sd1) / 2.0, (m + sd2) / 2.0, (m - sd2) / 2.0], dim=-1
    )
    valid_f = torch.stack([d1 >= -tol1, d1 >= -tol1, d2 >= -tol2, d2 >= -tol2], dim=-1)

    db = p * p - 4.0 * r
    sdb = torch.sqrt(torch.clamp_min(db, 0.0))
    z1 = (-p + sdb) / 2.0
    z2 = (-p - sdb) / 2.0
    sz1 = torch.sqrt(torch.clamp_min(z1, 0.0))
    sz2 = torch.sqrt(torch.clamp_min(z2, 0.0))
    roots_b = torch.stack([sz1, -sz1, sz2, -sz2], dim=-1)
    vb1 = (db >= 0.0) & (z1 >= 0.0)
    vb2 = (db >= 0.0) & (z2 >= 0.0)
    valid_b = torch.stack([vb1, vb1, vb2, vb2], dim=-1)

    y = torch.where(biquad[..., None], roots_b, roots_f)
    valid = torch.where(biquad[..., None], valid_b, valid_f)
    x = y - e[..., None]

    P3, P2, P1, P0 = p3[..., None], p2[..., None], p1[..., None], p0[..., None]
    for _ in range(6):
        f = (((x + P3) * x + P2) * x + P1) * x + P0
        fp = ((4.0 * x + 3.0 * P3) * x + 2.0 * P2) * x + P1
        fp = torch.where(torch.abs(fp) < _EPS, torch.where(fp < 0, -_EPS, _EPS), fp)
        x = x - f / fp
    valid = valid & ok_lead[..., None] & torch.isfinite(x)
    return torch.where(valid, x, 0.0), valid


def _kabsch(Xw: torch.Tensor, Yc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched absolute orientation: R, t with Yc_i ~= R Xw_i + t for 3-point
    (..., 3, 3) sets. The rotation is the polar factor of the correlation H,
    completed to full rank with the triangle-normal correlation, by 12
    determinant-scaled Newton polar steps X <- (X/g + g X^-T)/2 with
    closed-form 3x3 inverses."""
    Xm = torch.mean(Xw, dim=-2, keepdim=True)
    Ym = torch.mean(Yc, dim=-2, keepdim=True)
    Xc = Xw - Xm
    Yc_c = Yc - Ym
    H = Xc.transpose(-1, -2) @ Yc_c                              # (..., 3, 3) rank <= 2
    nx = torch.linalg.cross(Xc[..., 1, :] - Xc[..., 0, :], Xc[..., 2, :] - Xc[..., 0, :])
    ny = torch.linalg.cross(Yc_c[..., 1, :] - Yc_c[..., 0, :], Yc_c[..., 2, :] - Yc_c[..., 0, :])
    nx = nx / torch.clamp_min(torch.linalg.norm(nx, dim=-1, keepdim=True), 1e-30)
    ny = ny / torch.clamp_min(torch.linalg.norm(ny, dim=-1, keepdim=True), 1e-30)
    nrm = torch.linalg.norm(H, dim=(-2, -1), keepdim=True)
    H = H + nrm * nx[..., :, None] * ny[..., None, :]
    X = H / torch.clamp_min(nrm, 1e-30)
    for _ in range(12):
        gam = _cbrt(torch.clamp_min(torch.abs(_det3(X)), 1e-30))[..., None, None]
        X = 0.5 * (X / gam + gam * inv3(X).transpose(-1, -2))
    R = X.transpose(-1, -2)                                      # V U^T
    t = Ym[..., 0, :] - torch.einsum("...ij,...j->...i", R, Xm[..., 0, :])
    return R, t


def _law_of_cosines(s, cos_abg, abc2):
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack(
        [
            s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * cos_abg[..., 0] - abc2[..., 0],
            s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cos_abg[..., 1] - abc2[..., 1],
            s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cos_abg[..., 2] - abc2[..., 2],
        ],
        dim=-1,
    )


@mm_f32
def p3p_poses(
    Xs: torch.Tensor, xs: torch.Tensor, K: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grunert P3P: world points ``Xs`` (B, 3, 3) + pixels ``xs`` (B, 3, 2)
    -> up to 4 world-to-camera poses per sample.

    Returns ``(R (B, 4, 3, 3), t (B, 4, 3), valid (B, 4))``.
    """
    dt = Xs.dtype
    Kinv = torch.linalg.inv(K).to(dt)
    ones = torch.ones(xs.shape[:-1] + (1,), dtype=dt, device=xs.device)
    rays = torch.cat([xs, ones], dim=-1) @ Kinv.T                # (B, 3, 3)
    f = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)     # unit bearings

    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = Xs[..., 0, :], Xs[..., 1, :], Xs[..., 2, :]
    cos_a = torch.sum(f2 * f3, dim=-1)
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_g = torch.sum(f1 * f2, dim=-1)
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)

    geom_ok = b2 > _EPS
    b2s = torch.where(geom_ok, b2, 1.0)
    A = (a2 - c2) / b2s
    cb2 = c2 / b2s

    # u = s2/s1 = N(v)/D(v) substituted into the third law-of-cosines
    # equation gives N^2 - 2 cos_g N D + G D^2 = 0 (p3p.py:235-269).
    n2 = 1.0 - A
    n1 = 2.0 * A * cos_b
    n0 = -(1.0 + A)
    d1 = 2.0 * cos_a
    d0 = -2.0 * cos_g
    g2 = -cb2
    g1 = 2.0 * cb2 * cos_b
    g0 = 1.0 - cb2

    q4 = n2 * n2
    q3 = 2.0 * n2 * n1
    q2 = 2.0 * n2 * n0 + n1 * n1
    q1 = 2.0 * n1 * n0
    q0 = n0 * n0
    q3 = q3 - 2.0 * cos_g * (n2 * d1)
    q2 = q2 - 2.0 * cos_g * (n2 * d0 + n1 * d1)
    q1 = q1 - 2.0 * cos_g * (n1 * d0 + n0 * d1)
    q0 = q0 - 2.0 * cos_g * (n0 * d0)
    D2_2 = d1 * d1
    D2_1 = 2.0 * d1 * d0
    D2_0 = d0 * d0
    q4 = q4 + g2 * D2_2
    q3 = q3 + g2 * D2_1 + g1 * D2_2
    q2 = q2 + g2 * D2_0 + g1 * D2_1 + g0 * D2_2
    q1 = q1 + g1 * D2_0 + g0 * D2_1
    q0 = q0 + g0 * D2_0

    v, v_ok = quartic_roots(torch.stack([q4, q3, q2, q1, q0], dim=-1))  # (B, 4)

    Qv = v * v - 2.0 * cos_b[..., None] * v + 1.0
    Qv_ok = Qv > _EPS
    s1 = torch.sqrt(b2s[..., None] / torch.where(Qv_ok, Qv, 1.0))
    # u from the linear substitution (singular where D(v) ~ 0) or from the
    # third law-of-cosines quadratic; keep the candidate that best satisfies
    # the first equation.
    Dv = d1[..., None] * v + d0[..., None]
    D_ok = torch.abs(Dv) > 1e-6
    Nv = (n2[..., None] * v + n1[..., None]) * v + n0[..., None]
    u_lin = Nv / torch.where(D_ok, Dv, 1.0)
    disc_u = cos_g[..., None] ** 2 - 1.0 + cb2[..., None] * Qv
    sq_u = torch.sqrt(torch.clamp_min(disc_u, 0.0))
    u_qp = cos_g[..., None] + sq_u
    u_qm = cos_g[..., None] - sq_u
    ab2 = (a2 / b2s)[..., None]

    def _res1(u):
        return torch.abs(u * u + v * v - 2.0 * u * v * cos_a[..., None] - ab2 * Qv)

    inf = float("inf")
    r_lin = torch.where(D_ok, _res1(u_lin), inf)
    r_qp = torch.where(disc_u >= 0.0, _res1(u_qp), inf)
    r_qm = torch.where(disc_u >= 0.0, _res1(u_qm), inf)
    u = torch.where(r_lin <= torch.minimum(r_qp, r_qm), u_lin,
                    torch.where(r_qp <= r_qm, u_qp, u_qm))
    u_ok = torch.isfinite(torch.minimum(r_lin, torch.minimum(r_qp, r_qm)))
    s2 = u * s1
    s3 = v * s1
    valid = (
        v_ok & Qv_ok & u_ok & geom_ok[..., None]
        & (v > _EPS) & (u > _EPS) & (s1 > _EPS)
    )

    s = torch.stack([s1, s2, s3], dim=-1)                        # (B, 4, 3)

    # Distance-domain Newton polish on the three law-of-cosines residuals.
    cos_abg = torch.stack([cos_a, cos_b, cos_g], dim=-1)[..., None, :]  # (B, 1, 3)
    abc2 = torch.stack([a2, b2, c2], dim=-1)[..., None, :]
    eye = 1e-9 * torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(3):
        s1_, s2_, s3_ = s[..., 0], s[..., 1], s[..., 2]
        ca, cb, cg = cos_abg[..., 0], cos_abg[..., 1], cos_abg[..., 2]
        r = _law_of_cosines(s, cos_abg, abc2)
        zero = torch.zeros_like(s1_)
        J = torch.stack(
            [
                torch.stack([zero, 2.0 * (s2_ - s3_ * ca), 2.0 * (s3_ - s2_ * ca)], dim=-1),
                torch.stack([2.0 * (s1_ - s3_ * cb), zero, 2.0 * (s3_ - s1_ * cb)], dim=-1),
                torch.stack([2.0 * (s1_ - s2_ * cg), 2.0 * (s2_ - s1_ * cg), zero], dim=-1),
            ],
            dim=-2,
        )
        JtJ = J.transpose(-1, -2) @ J + eye
        g = torch.einsum("...ji,...j->...i", J, r)
        ds = torch.einsum("...ij,...j->...i", inv3(JtJ), g)
        s = s - ds
    valid = valid & torch.all(s > _EPS, dim=-1) & torch.all(torch.isfinite(s), dim=-1)

    # The polished distances must satisfy the law-of-cosines system.
    rfin = _law_of_cosines(s, cos_abg, abc2)
    scale2 = (a2 + b2 + c2)[..., None, None]
    valid = valid & torch.all(torch.abs(rfin) < 1e-3 * scale2 + 1e-9, dim=-1)
    Yc = s[..., :, None] * f[..., None, :, :]                    # (B, 4, 3, 3)
    Xw = Xs[..., None, :, :].expand(Yc.shape)
    R, t = _kabsch(Xw, Yc)
    valid = valid & torch.all(torch.isfinite(t), dim=-1)
    # A non-converged polar factor is not a rotation: require orthogonality
    # to float32 tolerance and reject mirror (det -1) factors.
    RtR = torch.einsum("...ji,...jk->...ik", R, R)
    orth_err = torch.amax(torch.abs(RtR - torch.eye(3, dtype=R.dtype, device=R.device)),
                          dim=(-2, -1))
    valid = valid & (orth_err < 2e-4) & (_det3(R) > 0)
    return R, t, valid
