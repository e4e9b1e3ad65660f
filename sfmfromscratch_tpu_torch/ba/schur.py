"""Schur-complement solvers for the LM normal equations
(counterpart of ``sfmfromscratch_tpu/ba/schur.py``).

The damped normal system is

    [U  W] [dc]   [gc]
    [W' V] [dp] = [gp]

with U block-diagonal over cameras (6x6), V block-diagonal over points (3x3)
and W one 6x3 block per observation. Eliminating the points gives the
reduced camera system S dc = b, S = U - W V^-1 W', b = gc - W V^-1 gp.

Segment sums are ``index_add_`` on the CPU and the sort-based
``index_put_(accumulate=True)`` on the card: ``index_add_`` on the card adds
with atomics in whatever order the threads land, so the same problem took
another LM path, to another final error, from run to run. Two backends: the
exact dense Cholesky of S for small camera counts (``dense_gate``), and
matrix-free block-Jacobi PCG otherwise.

Every cross-observation sum takes ``reduce_fn`` (None: the identity), applied
right after the local segment sum. The observation-sharded solver
(``parallel/sharded_ba.py``) passes an ``all_reduce`` over the ``data`` axis:
each rank sums its own observations and the reduced blocks are equal on
every rank. Damping, inverses and the dense Cholesky act on the reduced
values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sfmfromscratch_tpu_torch.ops.smallsvd import inv3_spd
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class SchurOperands(NamedTuple):
    U: torch.Tensor        # (C, 6, 6) damped camera blocks
    Vinv: torch.Tensor     # (P, 3, 3) inverted damped point blocks
    W: torch.Tensor        # (O, 6, 3) cross blocks
    gc: torch.Tensor       # (C, 6)
    gp: torch.Tensor       # (P, 3)
    obs_cam: torch.Tensor  # (O,)
    obs_pt: torch.Tensor   # (O,)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def segment_sum(x: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for in-range indices, deterministic on every
    device (each segment adds its rows in index order)."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    if x.is_cuda:
        return out.index_put_((idx,), x, accumulate=True)
    return out.index_add_(0, idx, x)


@mm_f32
def build_normal_blocks(
    Jc: torch.Tensor, Jp: torch.Tensor, r: torch.Tensor,
    obs_cam: torch.Tensor, obs_pt: torch.Tensor,
    num_cameras: int, num_points: int,
    lam: torch.Tensor,
    reduce_fn=None,
) -> SchurOperands:
    """Assemble damped U, V^-1, W, gc, gp from per-observation blocks.
    ``reduce_fn`` reduces the four segment sums across observation shards
    before the damping, which thus acts on the fully reduced diagonal.
    Damping is multiplicative on the diagonal, diag += lam * diag + 1e-8;
    V is inverted by the closed-form SPD Cholesky (``inv3_spd``)."""
    red = reduce_fn or _identity
    UtU = torch.einsum("oki,okj->oij", Jc, Jc)          # (O, 6, 6)
    VtV = torch.einsum("oki,okj->oij", Jp, Jp)          # (O, 3, 3)
    W = torch.einsum("oki,okj->oij", Jc, Jp)            # (O, 6, 3)
    gc_o = torch.einsum("oki,ok->oi", Jc, r)            # (O, 6)
    gp_o = torch.einsum("oki,ok->oi", Jp, r)            # (O, 3)

    U = red(segment_sum(UtU, obs_cam, num_cameras))
    V = red(segment_sum(VtV, obs_pt, num_points))
    gc = red(segment_sum(gc_o, obs_cam, num_cameras))
    gp = red(segment_sum(gp_o, obs_pt, num_points))

    eps = 1e-8
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    U = U + eye6 * (lam * torch.diagonal(U, dim1=-2, dim2=-1) + eps)[..., None, :]
    V = V + eye3 * (lam * torch.diagonal(V, dim1=-2, dim2=-1) + eps)[..., None, :]
    return SchurOperands(U=U, Vinv=inv3_spd(V), W=W, gc=gc, gp=gp,
                         obs_cam=obs_cam, obs_pt=obs_pt)


@mm_f32
def schur_matvec(op: SchurOperands, x: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """S x = U x - W V^-1 W' x for x of shape (C, 6); two reductions when
    sharded."""
    red = reduce_fn or _identity
    num_points = op.Vinv.shape[0]
    Ux = torch.einsum("cij,cj->ci", op.U, x)
    a = torch.einsum("oji,oj->oi", op.W, x[op.obs_cam])            # W' x  (O, 3)
    b = red(segment_sum(a, op.obs_pt, num_points))
    c = torch.einsum("pij,pj->pi", op.Vinv, b)                     # V^-1  (P, 3)
    d = torch.einsum("oij,oj->oi", op.W, c[op.obs_pt])             # W     (O, 6)
    return Ux - red(segment_sum(d, op.obs_cam, op.U.shape[0]))


@mm_f32
def schur_rhs(op: SchurOperands, reduce_fn=None) -> torch.Tensor:
    """b = gc - W V^-1 gp."""
    red = reduce_fn or _identity
    c = torch.einsum("pij,pj->pi", op.Vinv, op.gp)
    d = torch.einsum("oij,oj->oi", op.W, c[op.obs_pt])
    return op.gc - red(segment_sum(d, op.obs_cam, op.U.shape[0]))


@mm_f32
def back_substitute_points(op: SchurOperands, dc: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """dp = V^-1 (gp - W' dc)."""
    red = reduce_fn or _identity
    a = torch.einsum("oji,oj->oi", op.W, dc[op.obs_cam])
    b = red(segment_sum(a, op.obs_pt, op.Vinv.shape[0]))
    return torch.einsum("pij,pj->pi", op.Vinv, op.gp - b)


def conjugate_gradient(
    matvec, b: torch.Tensor, num_iters: int, tol: float = 1e-8, precond=None,
    tol_rel=0.0,
) -> torch.Tensor:
    """Capped-iteration (P)CG on a flat system. Stops after ``num_iters`` or
    once ||r||^2 <= max(tol, tol_rel^2 ||b||^2); the test runs before each
    step, on the host, as the JAX ``while_loop`` condition does."""
    if precond is None:
        def precond(r):
            return r

    bb = torch.dot(b, b)
    tol2 = torch.maximum(torch.as_tensor(tol, dtype=b.dtype, device=b.device),
                         torch.as_tensor(tol_rel, dtype=b.dtype, device=b.device) ** 2 * bb)
    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = torch.dot(b, z)
    it = 0
    while it < num_iters and bool(torch.dot(r, r) > tol2):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x


def point_cam_blocks(
    W: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor,
    num_cameras: int, num_points: int,
) -> torch.Tensor:
    """(P*C, 3, 6) per-(point, camera) sums of W^T."""
    return segment_sum(W.transpose(-1, -2), obs_pt * num_cameras + obs_cam,
                       num_points * num_cameras)


@mm_f32
def dense_schur_from_blocks(U: torch.Tensor, Vinv: torch.Tensor, Bflat: torch.Tensor) -> torch.Tensor:
    """Materialize S = U - W V^-1 W' as a dense (6C, 6C) matrix from the
    per-(point, camera) blocks of :func:`point_cam_blocks`."""
    C = U.shape[0]
    P = Vinv.shape[0]
    B = Bflat.reshape(P, C, 3, 6).transpose(1, 2).reshape(P, 3, 6 * C)
    VB = torch.einsum("pij,pja->pia", Vinv, B)
    S = -torch.einsum("pia,pib->ab", B, VB).reshape(C, 6, C, 6)
    ar = torch.arange(C, device=U.device)
    S[ar, :, ar, :] = S[ar, :, ar, :] + U
    return S.reshape(6 * C, 6 * C)


@mm_f32
def solve_schur_dense(op: SchurOperands, reduce_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense Cholesky solve of the reduced camera system (small camera
    counts). Where S is not positive definite the step is NaN, as the JAX
    ``cho_factor`` gives, and LM rejects it. Sharded, the per-(point, camera)
    blocks are reduced before the quadratic form (S is quadratic in them)."""
    red = reduce_fn or _identity
    C = op.U.shape[0]
    P = op.Vinv.shape[0]
    S = dense_schur_from_blocks(op.U, op.Vinv,
                                red(point_cam_blocks(op.W, op.obs_cam, op.obs_pt, C, P)))
    b = schur_rhs(op, red).reshape(-1)
    L, info = torch.linalg.cholesky_ex(S)
    dc = torch.cholesky_solve(b[:, None], L)[:, 0]
    dc = torch.where(info == 0, dc, float("nan")).reshape(C, 6)
    return dc, back_substitute_points(op, dc, red)


# Dense path only below this camera count, and while the per-(point, camera)
# blocks stay small (ba/schur.py:228-236).
DENSE_SCHUR_MAX_CAMS = 32
DENSE_SCHUR_MAX_CAMPOINTS = 2 ** 21


def dense_gate(num_cameras: int, num_points: int) -> bool:
    """True when the exact dense Schur path should be used; both counts are
    the padded ones."""
    return (
        num_cameras <= DENSE_SCHUR_MAX_CAMS
        and num_cameras * num_points <= DENSE_SCHUR_MAX_CAMPOINTS
    )


@mm_f32
def solve_schur(op: SchurOperands, cg_iters: int, tol_rel=0.0,
                reduce_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the reduced camera system by PCG with the damped camera blocks
    U^-1 as block-Jacobi preconditioner, then back-substitute the points.
    Returns (dc (C, 6), dp (P, 3)), the LM descent direction (to subtract)."""
    b = schur_rhs(op, reduce_fn)
    Uinv = torch.linalg.inv_ex(op.U)[0]

    def mv(xflat):
        return schur_matvec(op, xflat.reshape(b.shape), reduce_fn).reshape(-1)

    def pc(rflat):
        return torch.einsum("cij,cj->ci", Uinv, rflat.reshape(b.shape)).reshape(-1)

    dc = conjugate_gradient(mv, b.reshape(-1), num_iters=cg_iters, precond=pc,
                            tol_rel=tol_rel).reshape(b.shape)
    return dc, back_substitute_points(op, dc, reduce_fn)
