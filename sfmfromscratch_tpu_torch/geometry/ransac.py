"""Vectorized RANSAC: relative pose and fundamental-matrix inlier filters,
each hypothesis batch scored at once (counterpart of
``sfmfromscratch_tpu/geometry/ransac.py``).

Sampling is split in two steps. ``draw_uniforms`` draws the (B, s) uniforms
from a ``torch.Generator``; ``uniforms_to_indices`` maps them to minimal
samples exactly as the JAX ``sample_minimal_indices`` does. JAX draws its
uniforms with threefry, which torch cannot reproduce, so each entry point
takes ``uniforms=``: a test hands it the JAX-drawn uniforms and the two
packages then score the same hypotheses one for one. The adaptive programs
run their stages in a Python loop with one host read per stage, where JAX
runs a ``while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sfmfromscratch_tpu_torch.geometry.epipolar import (
    eight_point_fundamental,
    epipolar_distances,
    essential_from_fundamental,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import two_view_depths
from sfmfromscratch_tpu_torch.ops.smallsvd import decompose_essential
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class RansacPoseResult(NamedTuple):
    R: torch.Tensor            # (3, 3) best relative rotation
    t: torch.Tensor            # (3,) best unit translation
    F: torch.Tensor            # (3, 3) fundamental matrix of the winner
    inliers: torch.Tensor      # (N,) bool epipolar-inlier mask
    num_inliers: torch.Tensor  # () int
    cheirality_ok: torch.Tensor  # () bool: strict all-points-in-front held


def draw_uniforms(
    generator: torch.Generator, num_hypotheses: int, sample_size: int, device=None
) -> torch.Tensor:
    """(B, s) float32 uniforms in [0, 1) from ``generator``."""
    return torch.rand((num_hypotheses, sample_size), generator=generator,
                      device=device or generator.device, dtype=torch.float32)


def uniforms_to_indices(
    u: torch.Tensor, n: int, mask: Optional[torch.Tensor], sample_size: int
) -> torch.Tensor:
    """(..., B, s) uniforms -> (..., B, s) distinct valid indices per
    hypothesis, for a mask of shape (..., n) (or None).

    Strided buckets: point j belongs to bucket j % s, and uniform (b, i)
    picks the r-th valid member of bucket i (ransac.py:86-112)."""
    m = n // sample_size
    if mask is None:
        loc = torch.floor(u * m).to(torch.int32).clamp_max(m - 1)
    else:
        mask_bm = mask[..., : m * sample_size].reshape(
            mask.shape[:-1] + (m, sample_size)).transpose(-1, -2)        # (..., s, m)
        cnt = torch.sum(mask_bm, dim=-1)                                  # (..., s)
        rank = torch.cumsum(mask_bm.to(torch.int32), dim=-1)              # (..., s, m)
        k = torch.floor(u * torch.clamp_min(cnt, 1)[..., None, :].to(u.dtype)).to(torch.int32)
        k = torch.minimum(k, torch.clamp_min(cnt - 1, 0)[..., None, :].to(torch.int32))
        # position of the (k+1)-th valid member: #{i : rank_i <= k}
        loc = torch.sum((rank[..., None, :, :] <= k[..., None]).to(torch.int32), dim=-1)
        loc = loc.clamp_max(m - 1)
    offsets = torch.arange(sample_size, device=u.device, dtype=torch.int32)
    return (loc * sample_size + offsets).long()


def sample_minimal_indices(
    generator: torch.Generator, n: int, mask: Optional[torch.Tensor],
    num_hypotheses: int, sample_size: int,
) -> torch.Tensor:
    """(B, sample_size) distinct valid indices per hypothesis."""
    device = mask.device if mask is not None else None
    u = draw_uniforms(generator, num_hypotheses, sample_size, device)
    return uniforms_to_indices(u, n, mask, sample_size)


@mm_f32
def ransac_essential_pose(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_hypotheses: int = 1000,
    threshold: float = 1.0,
    sample_size: int = 8,
    min_cheirality_frac: float = 1.0,
    cheirality_subset: int = 1024,
    uniforms: Optional[torch.Tensor] = None,
    R_base: Optional[torch.Tensor] = None,
    t_base: Optional[torch.Tensor] = None,
) -> RansacPoseResult:
    """Relative-pose RANSAC (reference SFM.py:38-103), fully vectorized.

    Per hypothesis: 8-point F -> E = K2^T F K1 -> 4 (R, t) candidates; the
    candidate with the most points in front of both cameras wins; a
    hypothesis is strict when that count reaches ``min_cheirality_frac`` of
    the valid points of the cheirality subset. Strict hypotheses are ranked
    by MSAC score; with none strict, the max-cheirality hypothesis wins. Two
    rounds of locally-optimized refit follow.

    The base camera is canonical unless ``R_base``/``t_base`` are given
    (ransac.py:318-361): the base pose then enters only the cheirality
    check, which tests the candidate as R' = R_cand R_base^T,
    t' = t_cand - R' t_base; the candidate (R_cand, t_cand) is returned.

    ``uniforms`` (B, s) replaces the draw from ``generator``.
    """
    n = p1.shape[0]
    device = p1.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)

    if uniforms is None:
        uniforms = draw_uniforms(generator, num_hypotheses, sample_size, device)
    idx = uniforms_to_indices(uniforms.to(device), n, mask, sample_size)
    F = eight_point_fundamental(p1[idx], p2[idx])            # (B, 3, 3)
    E = essential_from_fundamental(F, K1, K2)
    R1, R2, t = decompose_essential(E)                       # (B,3,3) x2, (B,3)

    Rc = torch.stack([R1, R1, R2, R2], dim=1)                # (B, 4, 3, 3)
    tc = torch.stack([t, -t, t, -t], dim=1)                  # (B, 4, 3)

    ns = min(cheirality_subset, n)
    p1_s, p2_s, mask_s = p1[:ns], p2[:ns], mask[:ns]
    n_valid_s = torch.sum(mask_s)
    z1, z2 = two_view_depths(*_che_pose(Rc, tc, R_base, t_base), p1_s, p2_s, K1, K2)  # (B, 4, ns)
    eps = 1e-6
    front = (z1 > eps) & (z2 > eps) & mask_s[None, None, :]
    che_count = torch.sum(front, dim=-1)                     # (B, 4)
    best_che = torch.max(che_count, dim=-1).values           # (B,)

    d = epipolar_distances(F, p1, p2)                        # (B, N)
    inl = (d < threshold) & mask[None, :]
    inliers = torch.sum(inl, dim=-1)                         # (B,)
    thr2 = threshold * threshold
    msac = torch.sum(torch.clamp_max(d * d, thr2) * mask[None, :], dim=-1)

    strict = best_che >= (min_cheirality_frac * n_valid_s).to(best_che.dtype)
    strict_score = torch.where(strict, -msac, float("-inf"))
    any_strict = torch.max(strict_score) > float("-inf")
    best_strict = torch.argmax(strict_score)
    best_loose = torch.argmax(best_che * (n + 1) + inliers)
    best = torch.where(any_strict, best_strict, best_loose)

    F_b, inl_b, _ = _lo_refit(F[best], inl[best], msac[best], p1, p2, mask, threshold, rounds=2)
    return _pose_from_refit(F_b, inl_b, p1_s, p2_s, mask_s, K1, K2,
                            (min_cheirality_frac * n_valid_s).to(torch.int64), R_base, t_base)


def _che_pose(Rc: torch.Tensor, tc: torch.Tensor, R_base: Optional[torch.Tensor],
              t_base: Optional[torch.Tensor]):
    """The pose the depth test sees for candidates (Rc, tc): the candidate
    itself for a canonical base, else R' = Rc R_base^T, t' = tc - R' t_base."""
    if R_base is None:
        return Rc, tc
    Rb = R_base.to(Rc)
    Rr = Rc @ Rb.T
    return Rr, tc - torch.einsum("...ij,j->...i", Rr, t_base.to(tc))


@mm_f32
def ransac_essential_pose_batch(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,           # (P, N, 2)
    p2: torch.Tensor,           # (P, N, 2)
    K1: torch.Tensor,           # (P, 3, 3)
    K2: torch.Tensor,           # (P, 3, 3)
    mask: torch.Tensor,         # (P, N) bool
    num_hypotheses: int = 1024,
    threshold: float = 1.0,
    sample_size: int = 8,
    min_cheirality_frac: float = 0.75,
    cheirality_subset: int = 512,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacPoseResult:
    """:func:`ransac_essential_pose` over a leading pair axis
    (ransac.py:633-663, a ``vmap`` there and here): the fixed-count relative
    poses of P pairs, each with its own intrinsics, as one batch. Every
    result field gains a leading P dimension. ``uniforms`` (P, B, s)
    replaces the draws from ``generator``: pair b uses ``uniforms[b]``."""
    P = p1.shape[0]
    if uniforms is None:
        uniforms = torch.rand((P, num_hypotheses, sample_size), generator=generator,
                              device=p1.device, dtype=torch.float32)

    def one(u, a, b, ka, kb, m):
        return tuple(ransac_essential_pose(
            None, a, b, ka, kb, m, num_hypotheses=num_hypotheses, threshold=threshold,
            sample_size=sample_size, min_cheirality_frac=min_cheirality_frac,
            cheirality_subset=cheirality_subset, uniforms=u))

    return RansacPoseResult(*torch.func.vmap(one)(uniforms.to(p1.device), p1, p2, K1, K2, mask))


def _lo_refit(F_b, inl_b, msac_b, p1, p2, mask, threshold: float, rounds: int):
    """Locally-optimized refit: re-solve F from the winner's full inlier set
    (masked n-point), keep it when the MSAC score improves; ``rounds``
    rounds. Leading lane dimensions are allowed."""
    maskf = mask.to(p1.dtype)
    thr2 = threshold * threshold
    for _ in range(rounds):
        F_r = eight_point_fundamental(p1, p2, mask=inl_b)
        d_r = epipolar_distances(F_r, p1, p2)
        msac_r = torch.sum(torch.clamp_max(d_r * d_r, thr2) * maskf, dim=-1)
        better = msac_r < msac_b
        F_b = torch.where(better[..., None, None], F_r, F_b)
        inl_b = torch.where(better[..., None], (d_r < threshold) & mask, inl_b)
        msac_b = torch.where(better, msac_r, msac_b)
    return F_b, inl_b, msac_b


def _pose_from_refit(F_b, inl_b, p1_s, p2_s, mask_s, K1, K2, min_strict,
                     R_base=None, t_base=None) -> RansacPoseResult:
    """Decompose the refit F's essential matrix and re-select the cheirality
    candidate (the refit can change the pose, not just the inlier set).
    Leading lane dimensions are allowed, on K too; a base pose (``_che_pose``)
    is not."""
    eps = 1e-6
    E_f = essential_from_fundamental(F_b[..., None, :, :], K1[..., None, :, :],
                                     K2[..., None, :, :])
    R1f, R2f, tf = decompose_essential(E_f)
    Rcf = torch.cat([R1f, R1f, R2f, R2f], dim=-3)             # (..., 4, 3, 3)
    tcf = torch.cat([tf, -tf, tf, -tf], dim=-2)               # (..., 4, 3)
    z1f, z2f = two_view_depths(*_che_pose(Rcf, tcf, R_base, t_base),
                               p1_s[..., None, :, :], p2_s[..., None, :, :],
                               K1[..., None, :, :], K2[..., None, :, :])   # (..., 4, ns)
    front_f = (z1f > eps) & (z2f > eps) & mask_s[..., None, :]
    che_f = torch.sum(front_f, dim=-1)                        # (..., 4)
    cand = torch.argmax(che_f, dim=-1, keepdim=True)
    return RansacPoseResult(
        R=torch.take_along_dim(Rcf, cand[..., None, None], dim=-3)[..., 0, :, :],
        t=torch.take_along_dim(tcf, cand[..., None], dim=-2)[..., 0, :],
        F=F_b,
        inliers=inl_b,
        num_inliers=torch.sum(inl_b, dim=-1),
        cheirality_ok=torch.max(che_f, dim=-1).values >= min_strict,
    )


class RansacFResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


class RansacFAdaptiveResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    hyps_used: torch.Tensor    # hypotheses actually evaluated (int32)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by repeated squaring, in the order of XLA's ``integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _hypotheses_needed(
    best_count: torch.Tensor, n_valid: torch.Tensor, sample_size: int, confidence: float
) -> torch.Tensor:
    """Adaptive-RANSAC stopping rule in float32: with inlier ratio w from the
    best support so far, ``log(1-p) / log(1 - w^s)`` hypotheses give
    probability p of one all-inlier minimal sample (ransac.py:64-75)."""
    w = best_count.to(torch.float32) / torch.clamp_min(n_valid, 1).to(torch.float32)
    w = torch.clamp(w, 0.0, 1.0)
    fail = torch.clamp(1.0 - _integer_pow(w, sample_size), 1e-12, 1.0 - 1e-7)
    conf = torch.tensor(-confidence, dtype=torch.float32, device=w.device)
    return torch.log1p(conf) / torch.log(fail)


def _keep_going(best_count, done, n_valid, stage_size: int, max_hypotheses: int,
                sample_size: int, confidence: float) -> torch.Tensor:
    """The while-loop condition of the adaptive programs (ransac.py:216-226),
    per lane. The futility stop ends a lane whose two stages found no
    support beyond the minimal sample."""
    needed = _hypotheses_needed(best_count, n_valid, sample_size, confidence)
    futile = (done >= 2 * stage_size) & (best_count < sample_size + 4)
    return ((done.to(torch.float32) < torch.clamp_max(needed, float(max_hypotheses)))
            & (done < max_hypotheses) & ~futile)


def _fundamental_lanes(u, p1, p2, mask, threshold: float, sample_size: int):
    """Score (A, S, s) minimal samples of A lanes: (F, inliers, MSAC, count)
    per hypothesis."""
    n = p1.shape[-2]
    idx = uniforms_to_indices(u, n, mask, sample_size)                # (A, S, s)
    a = torch.arange(p1.shape[0], device=p1.device)[:, None, None]
    F = eight_point_fundamental(p1[a, idx], p2[a, idx])               # (A, S, 3, 3)
    d = epipolar_distances(F, p1[:, None], p2[:, None])               # (A, S, N)
    inl = (d < threshold) & mask[:, None, :]
    cnt = torch.sum(inl, dim=-1)
    msac = torch.sum(torch.clamp_max(d * d, threshold * threshold)
                     * mask[:, None, :].to(d.dtype), dim=-1)
    return F, inl, msac, cnt


@mm_f32
def ransac_fundamental_batch(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    num_hypotheses: int = 1000,
    threshold: float = 1.0,
    sample_size: int = 8,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacFResult:
    """Fixed-count fundamental-matrix RANSAC (the reference's
    ``find_inliers``, SFM.py:126-160) for P pairs (P, N, 2) at once: the
    hypothesis with the most epipolar inliers wins. ``uniforms`` (P, B, s)
    replaces the draw from ``generator``."""
    P = p1.shape[0]
    if uniforms is None:
        uniforms = torch.rand((P, num_hypotheses, sample_size), generator=generator,
                              device=p1.device, dtype=torch.float32)
    F, inl, _, cnt = _fundamental_lanes(uniforms.to(p1.device), p1, p2, mask, threshold,
                                        sample_size)
    best = torch.argmax(cnt, dim=-1)
    ar = torch.arange(P, device=p1.device)
    return RansacFResult(F=F[ar, best], inliers=inl[ar, best], num_inliers=cnt[ar, best])


def ransac_fundamental(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_hypotheses: int = 1000,
    threshold: float = 1.0,
    sample_size: int = 8,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacFResult:
    """``ransac_fundamental_batch`` of one pair; ``uniforms`` is (B, s)."""
    if mask is None:
        mask = torch.ones(p1.shape[:1], dtype=torch.bool, device=p1.device)
    res = ransac_fundamental_batch(
        generator, p1[None], p2[None], mask[None], num_hypotheses=num_hypotheses,
        threshold=threshold, sample_size=sample_size,
        uniforms=None if uniforms is None else uniforms[None],
    )
    return RansacFResult(*(v[0] for v in res))


@mm_f32
def ransac_fundamental_adaptive_batch(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    max_hypotheses: int = 6144,
    stage_size: int = 512,
    threshold: float = 1.0,
    sample_size: int = 8,
    confidence: float = 0.98,
    lo_rounds: int = 2,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacFAdaptiveResult:
    """Adaptive (early-terminating) fundamental-matrix RANSAC for P pairs.

    Stages of ``stage_size`` hypotheses; after each stage a lane's required
    count is re-derived from its best support (``_hypotheses_needed``) and
    the lane stops once it has drawn that many, or ``max_hypotheses``, or
    two futile stages (ransac.py:172-266). A Python loop replaces the JAX
    ``while_loop``: one host read per stage decides which lanes go on, and
    only those lanes are scored, so each lane keeps its own stage count and
    frozen winner, as under ``vmap``. Each lane finishes with ``lo_rounds``
    of locally-optimized refit.

    ``uniforms`` (P, stages, stage_size, s) replaces the draws from
    ``generator``: lane b's stage k uses ``uniforms[b, k]``.
    """
    P, n = p1.shape[0], p1.shape[1]
    dev = p1.device
    n_valid = torch.sum(mask, dim=-1)
    F_b = torch.eye(3, dtype=p1.dtype, device=dev).repeat(P, 1, 1)
    inl_b = torch.zeros((P, n), dtype=torch.bool, device=dev)
    msac_b = torch.full((P,), float("inf"), dtype=p1.dtype, device=dev)
    cnt_b = torch.zeros((P,), dtype=torch.int32, device=dev)
    done = torch.zeros((P,), dtype=torch.int32, device=dev)
    stage = 0
    while True:
        go = _keep_going(cnt_b, done, n_valid, stage_size, max_hypotheses, sample_size,
                         confidence).cpu()
        if not bool(go.any()):
            break
        lanes = torch.nonzero(go)[:, 0]
        ld = lanes.to(dev)
        if uniforms is None:
            u = torch.rand((len(lanes), stage_size, sample_size), generator=generator,
                           device=dev, dtype=torch.float32)
        else:
            u = uniforms[lanes, stage].to(dev)
        F, inl, msac, cnt = _fundamental_lanes(u, p1[ld], p2[ld], mask[ld], threshold,
                                               sample_size)
        b = torch.argmin(msac, dim=-1)
        ar = torch.arange(len(lanes), device=dev)
        F_s, inl_s, msac_s, cnt_s = F[ar, b], inl[ar, b], msac[ar, b], cnt[ar, b]
        better = msac_s < msac_b[ld]
        F_b[ld] = torch.where(better[:, None, None], F_s, F_b[ld])
        inl_b[ld] = torch.where(better[:, None], inl_s, inl_b[ld])
        msac_b[ld] = torch.where(better, msac_s, msac_b[ld])
        cnt_b[ld] = torch.where(better, cnt_s.to(torch.int32), cnt_b[ld])
        done[ld] += stage_size
        stage += 1
    F_b, inl_b, _ = _lo_refit(F_b, inl_b, msac_b, p1, p2, mask, threshold, lo_rounds)
    return RansacFAdaptiveResult(F=F_b, inliers=inl_b, num_inliers=torch.sum(inl_b, dim=-1),
                                 hyps_used=done)


def ransac_fundamental_adaptive(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    max_hypotheses: int = 6144,
    stage_size: int = 512,
    threshold: float = 1.0,
    sample_size: int = 8,
    confidence: float = 0.98,
    lo_rounds: int = 2,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacFAdaptiveResult:
    """``ransac_fundamental_adaptive_batch`` of one pair; ``uniforms`` is
    (stages, stage_size, s)."""
    if mask is None:
        mask = torch.ones(p1.shape[:1], dtype=torch.bool, device=p1.device)
    res = ransac_fundamental_adaptive_batch(
        generator, p1[None], p2[None], mask[None], max_hypotheses=max_hypotheses,
        stage_size=stage_size, threshold=threshold, sample_size=sample_size,
        confidence=confidence, lo_rounds=lo_rounds,
        uniforms=None if uniforms is None else uniforms[None],
    )
    return RansacFAdaptiveResult(*(v[0] for v in res))


def ransac_essential_pose_adaptive(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    max_hypotheses: int = 6144,
    stage_size: int = 512,
    threshold: float = 1.0,
    sample_size: int = 8,
    confidence: float = 0.98,
    min_cheirality_frac: float = 1.0,
    cheirality_subset: int = 1024,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacPoseResult:
    """Adaptive relative-pose RANSAC of one pair (ransac.py:443-594):
    :func:`ransac_essential_pose_adaptive_batch` of one lane. ``uniforms``
    (stages, stage_size, s) replaces the draws from ``generator``: stage k
    uses ``uniforms[k]``."""
    if mask is None:
        mask = torch.ones(p1.shape[:1], dtype=torch.bool, device=p1.device)
    res = ransac_essential_pose_adaptive_batch(
        generator, p1[None], p2[None], K1[None], K2[None], mask[None],
        max_hypotheses=max_hypotheses, stage_size=stage_size, threshold=threshold,
        sample_size=sample_size, confidence=confidence,
        min_cheirality_frac=min_cheirality_frac, cheirality_subset=cheirality_subset,
        uniforms=None if uniforms is None else uniforms[None],
    )
    return RansacPoseResult(*(v[0] for v in res))


@mm_f32
def ransac_essential_pose_adaptive_batch(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,           # (P, N, 2)
    p2: torch.Tensor,           # (P, N, 2)
    K1: torch.Tensor,           # (P, 3, 3)
    K2: torch.Tensor,           # (P, 3, 3)
    mask: torch.Tensor,         # (P, N) bool
    max_hypotheses: int = 6144,
    stage_size: int = 256,
    threshold: float = 1.0,
    sample_size: int = 8,
    confidence: float = 0.98,
    min_cheirality_frac: float = 0.75,
    cheirality_subset: int = 512,
    uniforms: Optional[torch.Tensor] = None,
    draw=None,
) -> RansacPoseResult:
    """Adaptive (early-terminating) relative-pose RANSAC for P pairs, each
    with its own intrinsics (ransac.py:443-630: the single-pair program and
    its ``vmap``). Per stage of ``stage_size`` hypotheses: 8-point F -> E ->
    4 (R, t) candidates, the best cheirality count; a hypothesis is strict
    when that count reaches ``min_cheirality_frac`` of the cheirality
    subset's valid points. Each lane carries its best strict hypothesis (by
    MSAC) and its best loose one (by cheirality, then inliers), and stops by
    the adaptive rule on the current winner's support. One host read per
    stage decides which lanes go on; only those are scored, so a finished
    lane keeps its winner while the others draw, as under ``vmap``. Then
    two rounds of LO refit and the candidate re-selection. Every result
    field gains a leading P dimension.

    ``uniforms`` (P, stages, stage_size, s) replaces the draws from
    ``generator``: lane b's stage k uses ``uniforms[b, k]``. ``draw``
    replaces both: ``draw(go, stage)`` takes the (P,) host mask of the
    lanes that would go on and returns the lanes that do and their
    (A, stage_size, s) uniforms, or uniforms None to stop. The pair-sharded
    relative poses of ``pipeline/global_sfm.py`` decide there, over every
    rank's lanes, which lanes go on and which uniforms each one takes.
    """
    P, n = p1.shape[0], p1.shape[1]
    dev, dt = p1.device, p1.dtype
    maskf = mask.to(dt)
    n_valid = torch.sum(mask, dim=-1)
    thr2 = threshold * threshold
    ns = min(cheirality_subset, n)
    p1_s, p2_s, mask_s = p1[:, :ns], p2[:, :ns], mask[:, :ns]
    min_strict = (min_cheirality_frac * torch.sum(mask_s, dim=-1)).to(torch.int32)
    eps = 1e-6

    done = torch.zeros((P,), dtype=torch.int32, device=dev)
    F_s = torch.eye(3, dtype=dt, device=dev).repeat(P, 1, 1)
    inl_s = torch.zeros((P, n), dtype=torch.bool, device=dev)
    msac_s = torch.full((P,), float("inf"), dtype=dt, device=dev)
    has_s = torch.zeros((P,), dtype=torch.bool, device=dev)
    F_l = F_s.clone()
    inl_l = inl_s.clone()
    lsc = torch.full((P,), float("-inf"), dtype=torch.float32, device=dev)
    best_cnt = torch.zeros((P,), dtype=torch.int32, device=dev)
    stage = 0
    if draw is None:
        def draw(go, stage):
            if not bool(go.any()):
                return go, None
            if uniforms is None:
                return go, torch.rand((int(go.sum()), stage_size, sample_size),
                                      generator=generator, device=dev, dtype=torch.float32)
            return go, uniforms[go.nonzero()[:, 0], stage].to(dev)

    while True:
        go, u = draw(_keep_going(best_cnt, done, n_valid, stage_size, max_hypotheses,
                                 sample_size, confidence).cpu(), stage)
        if u is None:
            break
        ld = torch.nonzero(go)[:, 0].to(dev)
        A = ld.shape[0]
        if A == 0:      # a shard whose lanes have all stopped while other ranks' draw
            stage += 1
            continue
        q1, q2, m, mf = p1[ld], p2[ld], mask[ld], maskf[ld]
        k1, k2 = K1[ld][:, None], K2[ld][:, None]
        idx = uniforms_to_indices(u, n, m, sample_size)                   # (A, S, s)
        a = torch.arange(A, device=dev)[:, None, None]
        F = eight_point_fundamental(q1[a, idx], q2[a, idx])               # (A, S, 3, 3)
        R1, R2, t = decompose_essential(essential_from_fundamental(F, k1, k2))
        Rc = torch.stack([R1, R1, R2, R2], dim=2)                         # (A, S, 4, 3, 3)
        tc = torch.stack([t, -t, t, -t], dim=2)                           # (A, S, 4, 3)
        z1, z2 = two_view_depths(Rc, tc, p1_s[ld][:, None, None], p2_s[ld][:, None, None],
                                 k1[:, None], k2[:, None])                # (A, S, 4, ns)
        front = (z1 > eps) & (z2 > eps) & mask_s[ld][:, None, None, :]
        best_che = torch.max(torch.sum(front, dim=-1), dim=-1).values     # (A, S)
        d = epipolar_distances(F, q1[:, None], q2[:, None])               # (A, S, N)
        inl = (d < threshold) & m[:, None, :]
        cnt = torch.sum(inl, dim=-1)
        msac = torch.sum(torch.clamp_max(d * d, thr2) * mf[:, None, :], dim=-1)
        strict = best_che >= min_strict[ld][:, None]
        sb = torch.argmax(torch.where(strict, -msac, float("-inf")), dim=-1)
        loose = best_che * (n + 1) + cnt
        lb = torch.argmax(loose, dim=-1)
        ar = torch.arange(A, device=dev)

        strict_b = strict[ar, sb]
        sb_better = strict_b & (msac[ar, sb] < msac_s[ld])
        F_s[ld] = torch.where(sb_better[:, None, None], F[ar, sb], F_s[ld])
        inl_s[ld] = torch.where(sb_better[:, None], inl[ar, sb], inl_s[ld])
        msac_s[ld] = torch.where(sb_better, msac[ar, sb], msac_s[ld])
        has = has_s[ld] | strict_b
        has_s[ld] = has
        lscb = loose[ar, lb].to(torch.float32)
        lb_better = lscb > lsc[ld]
        F_l[ld] = torch.where(lb_better[:, None, None], F[ar, lb], F_l[ld])
        inl_l[ld] = torch.where(lb_better[:, None], inl[ar, lb], inl_l[ld])
        lsc[ld] = torch.where(lb_better, lscb, lsc[ld])
        # The stopping rule follows the support of the current winner.
        bc = best_cnt[ld]
        zero = torch.zeros_like(bc)
        bc = torch.maximum(bc, torch.where(sb_better | (strict_b & ~has),
                                           cnt[ar, sb].to(torch.int32), zero))
        best_cnt[ld] = torch.maximum(bc, torch.where(has, bc, cnt[ar, lb].to(torch.int32)))
        done[ld] += stage_size
        stage += 1

    F0 = torch.where(has_s[:, None, None], F_s, F_l)
    inl0 = torch.where(has_s[:, None], inl_s, inl_l)
    d_l = epipolar_distances(F_l, p1, p2)
    msac0 = torch.where(has_s, msac_s, torch.sum(torch.clamp_max(d_l * d_l, thr2) * maskf, dim=-1))
    F_b, inl_b, _ = _lo_refit(F0, inl0, msac0, p1, p2, mask, threshold, rounds=2)
    return _pose_from_refit(F_b, inl_b, p1_s, p2_s, mask_s, K1, K2, min_strict)
