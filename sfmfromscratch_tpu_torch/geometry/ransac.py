"""Vectorized relative-pose RANSAC: all hypotheses as one batch
(counterpart of ``sfmfromscratch_tpu/geometry/ransac.py``).

Sampling is split in two steps. ``draw_uniforms`` draws the (B, s) uniforms
from a ``torch.Generator``; ``uniforms_to_indices`` maps them to minimal
samples exactly as the JAX ``sample_minimal_indices`` does. JAX draws its
uniforms with threefry, which torch cannot reproduce, so a test hands the
JAX-drawn uniforms to ``ransac_essential_pose(uniforms=...)`` and the two
packages then score the same hypotheses one for one.
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
    """(B, s) uniforms -> (B, s) distinct valid indices per hypothesis.

    Strided buckets: point j belongs to bucket j % s, and uniform (b, i)
    picks the r-th valid member of bucket i (ransac.py:86-112)."""
    m = n // sample_size
    if mask is None:
        loc = torch.floor(u * m).to(torch.int32).clamp_max(m - 1)
    else:
        mask_bm = mask[: m * sample_size].reshape(m, sample_size).T       # (s, m)
        cnt = torch.sum(mask_bm, dim=-1)                                   # (s,)
        rank = torch.cumsum(mask_bm.to(torch.int32), dim=-1)               # (s, m)
        k = torch.floor(u * torch.clamp_min(cnt, 1)[None, :].to(u.dtype)).to(torch.int32)
        k = torch.minimum(k, torch.clamp_min(cnt - 1, 0)[None, :].to(torch.int32))
        # position of the (k+1)-th valid member: #{i : rank_i <= k}
        loc = torch.sum((rank[None] <= k[:, :, None]).to(torch.int32), dim=-1)
        loc = loc.clamp_max(m - 1)
    offsets = torch.arange(sample_size, device=u.device, dtype=torch.int32)[None, :]
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
) -> RansacPoseResult:
    """Relative-pose RANSAC (reference SFM.py:38-103), fully vectorized.

    Per hypothesis: 8-point F -> E = K2^T F K1 -> 4 (R, t) candidates; the
    candidate with the most points in front of both cameras wins; a
    hypothesis is strict when that count reaches ``min_cheirality_frac`` of
    the valid points of the cheirality subset. Strict hypotheses are ranked
    by MSAC score; with none strict, the max-cheirality hypothesis wins. Two
    rounds of locally-optimized refit follow. The base camera is canonical.

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
    z1, z2 = two_view_depths(Rc, tc, p1_s, p2_s, K1, K2)     # (B, 4, ns)
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

    # Locally-optimized refit: re-solve F from the winner's full inlier set,
    # keep it when the MSAC score improves; two rounds.
    F_b, inl_b, msac_b = F[best], inl[best], msac[best]
    for _ in range(2):
        F_r = eight_point_fundamental(p1, p2, mask=inl_b)
        d_r = epipolar_distances(F_r, p1, p2)
        msac_r = torch.sum(torch.clamp_max(d_r * d_r, thr2) * mask)
        better = msac_r < msac_b
        F_b = torch.where(better, F_r, F_b)
        inl_b = torch.where(better, (d_r < threshold) & mask, inl_b)
        msac_b = torch.where(better, msac_r, msac_b)

    # Decompose the refit F's essential matrix and re-select the candidate.
    E_f = essential_from_fundamental(F_b[None], K1, K2)
    R1f, R2f, tf = decompose_essential(E_f)
    Rcf = torch.stack([R1f, R1f, R2f, R2f], dim=1)[0]        # (4, 3, 3)
    tcf = torch.stack([tf, -tf, tf, -tf], dim=1)[0]          # (4, 3)
    z1f, z2f = two_view_depths(Rcf, tcf, p1_s, p2_s, K1, K2)  # (4, ns)
    front_f = (z1f > eps) & (z2f > eps) & mask_s[None, :]
    che_f = torch.sum(front_f, dim=-1)                       # (4,)
    cand = torch.argmax(che_f)
    strict_f = torch.max(che_f) >= (min_cheirality_frac * n_valid_s).to(che_f.dtype)

    return RansacPoseResult(
        R=Rcf[cand],
        t=tcf[cand],
        F=F_b,
        inliers=inl_b,
        num_inliers=torch.sum(inl_b),
        cheirality_ok=strict_f,
    )
