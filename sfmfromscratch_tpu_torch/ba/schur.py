"""Schur-complement solvers for the LM normal equations
(counterpart of ``sfmfromscratch_tpu/ba/schur.py``).

The damped normal system is

    [U  W] [dc]   [gc]
    [W' V] [dp] = [gp]

with U block-diagonal over cameras (6x6), V block-diagonal over points (3x3)
and W one 6x3 block per observation. Eliminating the points gives the
reduced camera system S dc = b, S = U - W V^-1 W', b = gc - W V^-1 gp.

Every segment sum of the port is ``segment_sum(x, plan)`` over a
``SegmentPlan`` of its index vector (``segment_plan``), built once for as
long as the index vector stays fixed: ``lm_run`` plans the cameras and the
points once per solve (``schur_plans``, carried on ``SchurOperands``), and
on the dense path the (point, camera) pairs; averaging, triangulation and the
chain refresh plan their index vectors once per call. The card adds in the
order the plan fixes, in one launch of ``csrc/segment_sum.cu``
(``ops/cuda/segsum_kernel.py``), without atomics, so the same problem takes
the same LM path in every run; the CPU adds each segment's rows in index
order (``index_add_``). Two backends: the exact dense Cholesky of S for
small camera counts (``dense_gate``), and matrix-free block-Jacobi PCG
otherwise.

Every cross-observation sum takes ``reduce_fn`` (None: the identity), applied
right after the local segment sum. The observation-sharded solver
(``parallel/sharded_ba.py``) passes an ``all_reduce`` over the ``data`` axis:
each rank sums its own observations and the reduced blocks are equal on
every rank. Damping, inverses and the dense Cholesky act on the reduced
values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from sfmfromscratch_tpu_torch.ops.cuda import segsum_kernel
from sfmfromscratch_tpu_torch.ops.smallsvd import inv3_spd
from sfmfromscratch_tpu_torch.utils import profiling
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class SegmentPlan(NamedTuple):
    """How the rows of one index vector fall into segments (``segment_plan``)."""
    idx: torch.Tensor        # (O,) the segment of each row, as given
    perm: torch.Tensor       # (O,) int32, the rows in segment order (a stable sort)
    offsets: torch.Tensor    # (S+1,) int32, segment starts in perm, empty segments included
    long_segs: torch.Tensor  # (L,) int32, the segments of more than LONG_ROWS rows
    group: int               # lanes of every other segment on the card


class SchurPlans(NamedTuple):
    cam: SegmentPlan         # obs_cam over the cameras
    pt: SegmentPlan          # obs_pt over the points


class SchurOperands(NamedTuple):
    U: torch.Tensor        # (C, 6, 6) damped camera blocks
    Vinv: torch.Tensor     # (P, 3, 3) inverted damped point blocks
    W: torch.Tensor        # (O, 6, 3) cross blocks
    gc: torch.Tensor       # (C, 6)
    gp: torch.Tensor       # (P, 3)
    obs_cam: torch.Tensor  # (O,)
    obs_pt: torch.Tensor   # (O,)
    plans: SchurPlans


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def segment_plan(idx: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of ``idx`` (O,), in-range indices, over ``num_segments``
    segments, on ``idx``'s device: one host read, of the plan's launch
    shape, none where there are no rows. Raises where an index is out of
    range. The counter ``segsum_plans`` of the innermost open span grows by
    one."""
    O, S = idx.shape[0], num_segments
    if O >= 2 ** 31 or not 0 <= S < 2 ** 31 - 1:
        raise ValueError(f"segment plan of {O} rows and {S} segments: out of int32's range")
    if S == 0 < O:
        raise ValueError("segment plan: indices outside [0, 0)")
    profiling.count("segsum_plans")
    if O == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=idx.device)
        return SegmentPlan(idx=idx, perm=empty, long_segs=empty, group=1,
                           offsets=torch.zeros(S + 1, dtype=torch.int32, device=idx.device))
    sorted_idx, perm = torch.sort(idx, stable=True)
    bounds = torch.arange(S + 1, dtype=sorted_idx.dtype, device=idx.device)
    offsets = torch.searchsorted(sorted_idx, bounds, out_int32=True)
    counts = offsets[1:] - offsets[:-1]
    long_mask = counts > segsum_kernel.LONG_ROWS
    # The long segments first, in index order.
    order = torch.argsort(long_mask.to(torch.uint8), descending=True, stable=True)
    num_long, max_short, first, last = torch.stack([
        long_mask.sum(dtype=torch.int32), torch.where(long_mask, 0, counts).max(),
        offsets[0], offsets[-1]]).tolist()
    if (first, last) != (0, O):
        raise ValueError(f"segment plan: indices outside [0, {S})")
    lanes = max(1, -(-max_short // segsum_kernel.ROWS_PER_LANE))
    group = min(32, 1 << (lanes - 1).bit_length())
    return SegmentPlan(idx=idx, perm=perm.to(torch.int32), offsets=offsets,
                       long_segs=order[:num_long].to(torch.int32), group=group)


def schur_plans(obs_cam: torch.Tensor, obs_pt: torch.Tensor, num_cameras: int,
                num_points: int) -> SchurPlans:
    """The plans of one LM solve's camera and point sums."""
    return SchurPlans(cam=segment_plan(obs_cam, num_cameras), pt=segment_plan(obs_pt, num_points))


def segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """``jax.ops.segment_sum`` of the rows of ``x`` (O, ...) over ``plan``
    (``segment_plan`` of their indices), deterministic on every device: on
    the card one launch of the segment-sum kernel in the order the plan
    fixes, on the CPU each segment's rows added in index order. The counter
    ``segsum_launches`` of the innermost open span grows by one; a sum of no
    rows is zeros, with no launch."""
    S = plan.offsets.shape[0] - 1
    rest = tuple(x.shape[1:])
    if x.shape[0] == 0:
        return x.new_zeros((S,) + rest)
    profiling.count("segsum_launches")
    rows = x.reshape(x.shape[0], math.prod(rest)).contiguous()
    return segsum_kernel.segment_sum_planned(rows, plan).reshape((S,) + rest)


@mm_f32
def build_normal_blocks(
    Jc: torch.Tensor, Jp: torch.Tensor, r: torch.Tensor, plans: SchurPlans,
    lam: torch.Tensor, reduce_fn=None,
) -> SchurOperands:
    """Assemble damped U, V^-1, W, gc, gp from per-observation blocks, the
    observations' cameras and points given by ``plans`` (``schur_plans``),
    which go to every segment sum here and, on the operands, to every later
    one. ``reduce_fn`` reduces the four segment sums across observation
    shards before the damping, which thus acts on the fully reduced
    diagonal. Damping is multiplicative on the diagonal, diag += lam * diag
    + 1e-8; V is inverted by the closed-form SPD Cholesky (``inv3_spd``)."""
    red = reduce_fn or _identity
    UtU = torch.einsum("oki,okj->oij", Jc, Jc)          # (O, 6, 6)
    VtV = torch.einsum("oki,okj->oij", Jp, Jp)          # (O, 3, 3)
    W = torch.einsum("oki,okj->oij", Jc, Jp)            # (O, 6, 3)
    gc_o = torch.einsum("oki,ok->oi", Jc, r)            # (O, 6)
    gp_o = torch.einsum("oki,ok->oi", Jp, r)            # (O, 3)

    U = red(segment_sum(UtU, plans.cam))
    V = red(segment_sum(VtV, plans.pt))
    gc = red(segment_sum(gc_o, plans.cam))
    gp = red(segment_sum(gp_o, plans.pt))

    eps = 1e-8
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    U = U + eye6 * (lam * torch.diagonal(U, dim1=-2, dim2=-1) + eps)[..., None, :]
    V = V + eye3 * (lam * torch.diagonal(V, dim1=-2, dim2=-1) + eps)[..., None, :]
    return SchurOperands(U=U, Vinv=inv3_spd(V), W=W, gc=gc, gp=gp,
                         obs_cam=plans.cam.idx, obs_pt=plans.pt.idx, plans=plans)


@mm_f32
def schur_matvec(op: SchurOperands, x: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """S x = U x - W V^-1 W' x for x of shape (C, 6); two reductions when
    sharded."""
    red = reduce_fn or _identity
    Ux = torch.einsum("cij,cj->ci", op.U, x)
    a = torch.einsum("oji,oj->oi", op.W, x[op.obs_cam])            # W' x  (O, 3)
    b = red(segment_sum(a, op.plans.pt))
    c = torch.einsum("pij,pj->pi", op.Vinv, b)                     # V^-1  (P, 3)
    d = torch.einsum("oij,oj->oi", op.W, c[op.obs_pt])             # W     (O, 6)
    return Ux - red(segment_sum(d, op.plans.cam))


@mm_f32
def schur_rhs(op: SchurOperands, reduce_fn=None) -> torch.Tensor:
    """b = gc - W V^-1 gp."""
    red = reduce_fn or _identity
    c = torch.einsum("pij,pj->pi", op.Vinv, op.gp)
    d = torch.einsum("oij,oj->oi", op.W, c[op.obs_pt])
    return op.gc - red(segment_sum(d, op.plans.cam))


@mm_f32
def back_substitute_points(op: SchurOperands, dc: torch.Tensor, reduce_fn=None) -> torch.Tensor:
    """dp = V^-1 (gp - W' dc)."""
    red = reduce_fn or _identity
    a = torch.einsum("oji,oj->oi", op.W, dc[op.obs_cam])
    b = red(segment_sum(a, op.plans.pt))
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


def point_cam_blocks(W: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(P*C, 3, 6) per-(point, camera) sums of W^T; ``plan`` is the plan of
    ``obs_pt * C + obs_cam`` over the P * C pairs."""
    return segment_sum(W.transpose(-1, -2), plan)


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
def solve_schur_dense(op: SchurOperands, plan: SegmentPlan,
                      reduce_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense Cholesky solve of the reduced camera system (small camera
    counts), with ``plan`` the (point, camera) pairs' (``point_cam_blocks``).
    Where S is not positive definite the step is NaN, as the JAX
    ``cho_factor`` gives, and LM rejects it. Sharded, the per-(point, camera)
    blocks are reduced before the quadratic form (S is quadratic in them)."""
    red = reduce_fn or _identity
    C = op.U.shape[0]
    S = dense_schur_from_blocks(op.U, op.Vinv, red(point_cam_blocks(op.W, plan)))
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
