"""Global motion averaging: rotation and translation averaging on the view
graph (counterpart of ``sfmfromscratch_tpu/geometry/averaging.py``).

Conventions: world-to-camera poses ``x_cam = R X + t``; an edge (i, j)
carries ``R_ij = R_j R_i^T`` and the translation direction
``t_ij ~ R_j (c_i - c_j)``, with ``c = -R^T t`` the camera centre.

The solvers take padded edge lists (weight-0 edges are inert) and keep the
JAX package's arithmetic: robust weights are normalised by their mean over
the whole, padded, list, so a caller that pads as the JAX engine does gets
its numbers. Segment sums are ``index_add_`` (``ba/schur.py::segment_sum``);
on CUDA they sum in any order, so card and CPU agree to rounding. The JAX
``lax.scan`` sweeps become Python loops with no host read; the chordal
initialisation's conjugate gradients read the residual on the host before
each step, as the JAX ``while_loop`` tests it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ba.schur import conjugate_gradient, segment_sum
from sfmfromscratch_tpu_torch.geometry.triangulation import two_view_depths
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


def _project_so3(M: torch.Tensor) -> torch.Tensor:
    """Batched projection onto SO(3): U diag(1, 1, d) V^T for M = U S V^T
    with d = sign det(U V^T); independent of the SVD's sign choices."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    d = torch.where(d == 0, torch.ones_like(d), torch.sign(d))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _add_row0(out: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out.at[0].add(v)``."""
    return torch.cat([out[:1] + v[None], out[1:]])


def _anneal(start: float, final: float, num_iters: int, t: int, dtype, device) -> torch.Tensor:
    """``max(start * decay ** t, final)`` in the JAX dtype, decay chosen so
    the threshold reaches ``final`` at half of ``num_iters``."""
    decay = (final / start) ** (1.0 / max(num_iters // 2, 1))
    tt = torch.tensor(float(t), dtype=dtype, device=device)
    return torch.clamp_min(start * decay ** tt, final)


@mm_f32
def rotation_averaging(
    R_rel: torch.Tensor,        # (E, 3, 3) relative rotations R_ij = R_j R_i^T
    edge_i: torch.Tensor,       # (E,) int
    edge_j: torch.Tensor,       # (E,) int
    R_init: torch.Tensor,       # (C, 3, 3) initial absolute rotations
    edge_w: Optional[torch.Tensor] = None,   # (E,) weights; 0 disables an edge
    num_cameras: int = 0,
    num_iters: int = 64,
    eps_start: float = 0.5,
    eps_final: float = 0.05,
) -> torch.Tensor:
    """Robust rotation averaging by IRLS-weighted SO(3) Jacobi sweeps with an
    annealed Huber -> Weiszfeld-L1 weight ``w_e = 1 / max(r_e, eps_t)`` on the
    chordal residual ``r_e = ||R_ij R_i - R_j||_F`` (averaging.py:43-91).
    Each sweep sets ``R_i <- proj_SO3(sum_e w_e contribution_e + 0.1 R_i)``
    and re-anchors the gauge to ``R_0 = I``."""
    C = num_cameras if num_cameras else R_init.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    w0 = torch.ones(R_rel.shape[0], dtype=R_rel.dtype, device=R_rel.device) \
        if edge_w is None else edge_w
    R_rel_T = R_rel.transpose(-1, -2)
    R = R_init
    for t in range(num_iters):
        eps_t = _anneal(eps_start, eps_final, num_iters, t, R_init.dtype, R_init.device)
        Ri, Rj = R[ei], R[ej]
        r = torch.linalg.norm(R_rel @ Ri - Rj, dim=(-2, -1))
        w = w0 / torch.maximum(r, eps_t)
        w = w / torch.clamp_min(torch.mean(w), 1e-9)        # keep the damping ratio fixed
        S = segment_sum(w[:, None, None] * (R_rel_T @ Rj), ei, C)
        S = S + segment_sum(w[:, None, None] * (R_rel @ Ri), ej, C)
        S = S + 0.1 * R
        Rn = _project_so3(S)
        R = Rn @ Rn[0].transpose(-1, -2)[None]
    return R


@mm_f32
def chordal_rotation_init(
    R_rel: torch.Tensor,
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    R_init: torch.Tensor,       # (C, 3, 3) warm start
    edge_w: Optional[torch.Tensor] = None,
    num_cameras: int = 0,
    cg_iters: int = 512,
    irls_rounds: int = 2,
) -> torch.Tensor:
    """Chordal relaxation (Martinec-Pajdla): solve the linear system
    ``min_M sum_e w_e ||M_j - R_ij M_i||_F^2`` over unconstrained 3x3 blocks
    by matrix-free CG, with ``irls_rounds`` Huber reweightings and camera 0
    anchored to ``R_init[0]`` by a quadratic penalty, then project to SO(3)
    (averaging.py:94-166)."""
    C = num_cameras if num_cameras else R_init.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    w0 = torch.ones(R_rel.shape[0], dtype=R_rel.dtype, device=R_rel.device) \
        if edge_w is None else edge_w
    w0 = w0 / torch.clamp_min(torch.mean(w0), 1e-9)
    anchor = 4.0
    R_rel_T = R_rel.transpose(-1, -2)

    def S_op(M, w):
        Mi, Mj = M[ei], M[ej]
        wi = w[:, None, None]
        S = segment_sum(wi * (Mj - R_rel @ Mi), ej, C)
        S = S + segment_sum(wi * (Mi - R_rel_T @ Mj), ei, C)
        return _add_row0(S, anchor * M[0])

    b = _add_row0(torch.zeros((C, 3, 3), dtype=R_init.dtype, device=R_init.device),
                  anchor * R_init[0])
    M = R_init
    for _ in range(max(irls_rounds, 1)):
        r = torch.linalg.norm(R_rel @ M[ei] - M[ej], dim=(-2, -1))
        w = w0 / torch.clamp_min(r / 0.3, 1.0)
        rhs = (b - S_op(M, w)).reshape(-1)
        d = conjugate_gradient(lambda x: S_op(x.reshape(C, 3, 3), w).reshape(-1), rhs,
                               num_iters=cg_iters)
        M = M + d.reshape(C, 3, 3)
    R = _project_so3(M)
    return (R @ R[0].transpose(-1, -2)[None]) @ R_init[0][None]


def _cg_fixed(apply, c: torch.Tensor, b: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """Plain CG for exactly ``cg_iters`` steps from ``c`` (the JAX ``scan``:
    no early exit, guarded divisions)."""
    rr = b - apply(c)
    p = rr
    rs = torch.sum(rr * rr)
    x = c
    for _ in range(cg_iters):
        Ap = apply(p)
        denom = torch.sum(p * Ap)
        alpha = rs / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        x = x + alpha * p
        rr = rr - alpha * Ap
        rs_new = torch.sum(rr * rr)
        beta = rs_new / torch.where(rs < 1e-12, 1e-12, rs)
        p = rr + beta * p
        rs = rs_new
    return x


@mm_f32
def translation_averaging(
    u_dir: torch.Tensor,        # (E, 3) unit world directions of (c_i - c_j)
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    c_init: torch.Tensor,       # (C, 3) initial camera centres
    edge_w: Optional[torch.Tensor] = None,
    num_cameras: int = 0,
    num_iters: int = 12,
    cg_iters: int = 64,
    huber_start: float = 0.5,
    huber_final: float = 0.05,
    edge_s: Optional[torch.Tensor] = None,   # (E,) per-edge scale estimates
) -> torch.Tensor:
    """Robust translation averaging on the view graph, matrix-free
    (averaging.py:169-316). With ``edge_s``, each IRLS round solves the
    anchored Laplacian system ``min_c sum_e w_e ||c_i - c_j - s_e u_e||^2``,
    ``s_e`` blended from the data towards the current stretch; without it,
    Govindu's projection least squares with a linear stretch gauge. Both
    Huber-damp edges by their scale-free residual, annealed; camera 0 is
    pinned at the origin."""
    C = num_cameras if num_cameras else c_init.shape[0]
    ei, ej = edge_i.long(), edge_j.long()
    dt, dev = c_init.dtype, c_init.device
    w0 = torch.ones(u_dir.shape[0], dtype=u_dir.dtype, device=u_dir.device) \
        if edge_w is None else edge_w
    pin = 10.0
    sum_w0 = torch.clamp_min(torch.sum(w0), 1e-9)
    c = c_init - c_init[0][None]

    if edge_s is not None:
        s_data = edge_s.to(u_dir.dtype)

        def apply_L(cc, w):
            d = cc[ei] - cc[ej]
            wd = w[:, None] * d
            out = segment_sum(wd, ei, C) - segment_sum(wd, ej, C)
            out = _add_row0(out, pin * cc[0])
            return out + 1e-8 * cc

        for t in range(num_iters):
            delta_t = _anneal(huber_start, huber_final, num_iters, t, dt, dev)
            d = c[ei] - c[ej]
            along = torch.sum(u_dir * d, dim=-1)
            lam = 0.5 ** torch.tensor(float(t), dtype=dt, device=dev)
            s = lam * s_data + (1.0 - lam) * torch.maximum(along, 0.05 * s_data)
            r = torch.linalg.norm(d - s[:, None] * u_dir, dim=-1)
            rn = r / torch.clamp_min(s, 1e-9)
            w = w0 * torch.clamp_max(delta_t / torch.clamp_min(rn, 1e-9), 1.0)
            wsu = (w * s)[:, None] * u_dir
            b = segment_sum(wsu, ei, C) - segment_sum(wsu, ej, C)
            c_new = _cg_fixed(lambda p: apply_L(p, w), c, b, cg_iters)
            c = c_new - c_new[0][None]
        return c

    rho = 1.0
    target = sum_w0

    def gvec(w):
        wu = w[:, None] * u_dir
        return segment_sum(wu, ei, C) - segment_sum(wu, ej, C)

    def apply_A(cc, w, g):
        d = cc[ei] - cc[ej]
        proj = d - u_dir * torch.sum(u_dir * d, dim=-1, keepdim=True)
        wp = w[:, None] * proj
        out = segment_sum(wp, ei, C) - segment_sum(wp, ej, C)
        out = _add_row0(out, pin * cc[0])
        return out + rho * torch.sum(g * cc) * g

    for t in range(num_iters):
        delta_t = _anneal(huber_start, huber_final, num_iters, t, dt, dev)
        d = c[ei] - c[ej]
        along = torch.sum(u_dir * d, dim=-1)
        mean_len = torch.sum(w0 * torch.abs(along)) / sum_w0
        scale = torch.clamp_min(mean_len, 1e-9)
        r = torch.linalg.norm(d - along[:, None] * u_dir, dim=-1) / scale
        w = w0 * torch.clamp_max(delta_t / torch.clamp_min(r, 1e-9), 1.0)
        w = w * torch.where(along > 0, 1.0, 0.05)
        g = gvec(w)
        b = rho * target * g
        c_new = _cg_fixed(lambda p: apply_A(p, w, g), c, b, cg_iters)
        c = c_new - c_new[0][None]
    return c


@mm_f32
def relative_translations_known_rotations(
    R_ij: torch.Tensor,    # (E, 3, 3) relative rotations (e.g. from averaging)
    p1: torch.Tensor,      # (E, N, 2) pixels in image i
    p2: torch.Tensor,      # (E, N, 2) pixels in image j
    K1: torch.Tensor,      # (E, 3, 3)
    K2: torch.Tensor,      # (E, 3, 3)
    mask: torch.Tensor,    # (E, N) bool inlier masks
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge translation directions given trusted relative rotations
    (averaging.py:319-387): each inlier gives the linear constraint
    ``t . (c x r2) = 0`` with ``c = R_ij r1``; the direction is the smallest
    eigenvector of the 3x3 scatter of unit constraint normals, signed by the
    cheirality majority. Returns ``(t (E, 3), conf (E,))`` with ``conf`` the
    relative eigengap."""
    K1i = torch.linalg.inv(K1)
    K2i = torch.linalg.inv(K2)
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]

    def backproject(Ki, u, v):
        return (
            Ki[:, 0, 0, None] * u + Ki[:, 0, 1, None] * v + Ki[:, 0, 2, None],
            Ki[:, 1, 0, None] * u + Ki[:, 1, 1, None] * v + Ki[:, 1, 2, None],
            Ki[:, 2, 0, None] * u + Ki[:, 2, 1, None] * v + Ki[:, 2, 2, None],
        )

    r1x, r1y, r1z = backproject(K1i, u1, v1)
    r2x, r2y, r2z = backproject(K2i, u2, v2)
    cx = R_ij[:, 0, 0, None] * r1x + R_ij[:, 0, 1, None] * r1y + R_ij[:, 0, 2, None] * r1z
    cy = R_ij[:, 1, 0, None] * r1x + R_ij[:, 1, 1, None] * r1y + R_ij[:, 1, 2, None] * r1z
    cz = R_ij[:, 2, 0, None] * r1x + R_ij[:, 2, 1, None] * r1y + R_ij[:, 2, 2, None] * r1z
    wx = cy * r2z - cz * r2y
    wy = cz * r2x - cx * r2z
    wz = cx * r2y - cy * r2x
    norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    s = mask.to(wx.dtype) / torch.clamp_min(norm, 1e-12)
    wx, wy, wz = wx * s, wy * s, wz * s

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    M = torch.stack([
        torch.stack([dot(wx, wx), dot(wx, wy), dot(wx, wz)], -1),
        torch.stack([dot(wy, wx), dot(wy, wy), dot(wy, wz)], -1),
        torch.stack([dot(wz, wx), dot(wz, wy), dot(wz, wz)], -1),
    ], -2)
    evals, evecs = torch.linalg.eigh(M)             # ascending
    t = evecs[..., :, 0]
    conf = (evals[..., 1] - evals[..., 0]) / torch.clamp_min(evals[..., 1], 1e-9)

    z1, z2 = two_view_depths(R_ij, t, p1, p2, K1, K2)
    pos = torch.sum(mask & (z1 > 0) & (z2 > 0), dim=-1)
    neg = torch.sum(mask & (z1 < 0) & (z2 < 0), dim=-1)
    t = t * torch.where(pos >= neg, 1.0, -1.0)[:, None]
    return t, conf


def _host_walk(num_cameras, edge_i, edge_j, step_fwd, step_back, init):
    """First-reach walk over the edges in order until no camera is added."""
    seen = np.zeros(num_cameras, bool)
    seen[0] = True
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    changed = True
    while changed:
        changed = False
        for e in range(len(ei)):
            i, j = int(ei[e]), int(ej[e])
            if seen[i] and not seen[j]:
                init[j] = step_fwd(e, init[i])
                seen[j] = True
                changed = True
            elif seen[j] and not seen[i]:
                init[i] = step_back(e, init[j])
                seen[i] = True
                changed = True
    return init


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def chain_initial_rotations(R_rel, edge_i, edge_j, num_cameras: int, device=None) -> torch.Tensor:
    """Host spanning-chain initialisation: walk the edges in order, composing
    ``R_j = R_ij R_i`` the first time camera j is reached; cameras never
    reached stay identity (averaging.py:390-417). Returns float32 on
    ``device`` (default: that of ``R_rel`` when it is a tensor)."""
    if device is None and isinstance(R_rel, torch.Tensor):
        device = R_rel.device
    Rr = _host(R_rel).astype(np.float64)
    R = _host_walk(num_cameras, _host(edge_i), _host(edge_j),
                   lambda e, Ri: Rr[e] @ Ri, lambda e, Rj: Rr[e].T @ Rj,
                   np.tile(np.eye(3, dtype=np.float64), (num_cameras, 1, 1)))
    return torch.as_tensor(R, dtype=torch.float32, device=device)


def chain_initial_centers(u_dir, edge_i, edge_j, num_cameras: int, device=None) -> torch.Tensor:
    """Host centre initialisation: walk the edges, stepping along the edge
    direction (``c_i - c_j = u``) the first time a camera is reached
    (averaging.py:420-446)."""
    if device is None and isinstance(u_dir, torch.Tensor):
        device = u_dir.device
    u = _host(u_dir).astype(np.float64)
    c = _host_walk(num_cameras, _host(edge_i), _host(edge_j),
                   lambda e, ci: ci - u[e], lambda e, cj: cj + u[e],
                   np.zeros((num_cameras, 3), np.float64))
    return torch.as_tensor(c, dtype=torch.float32, device=device)
