"""NN-ratio descriptor matching (counterpart of ``sfmfromscratch_tpu/ops/matcher.py``).

The distance/top-2 core goes through the matcher kernel's wrapper
(``ops/cuda/match_kernel.py``): the CUDA kernel for CUDA tensors, its plain
version for CPU tensors. Outputs are fixed-capacity and sorted best-first
(ascending NN distance ratio), the reference's contract
(NNRatioFeatureMatcher.py:56-58).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sfmfromscratch_tpu_torch.ops.cuda.match_kernel import match_top2_fused
from sfmfromscratch_tpu_torch.types import MatchResult
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

_BIG = 1e12


def pairwise_sq_dists(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(n1, D), (n2, D) -> (n1, n2) squared Euclidean distances via matmul."""
    n1sq = torch.sum(d1 * d1, dim=-1, keepdim=True)
    n2sq = torch.sum(d2 * d2, dim=-1, keepdim=True).T
    with f32_precision():
        cross = d1 @ d2.T
    return torch.clamp_min(n1sq + n2sq - 2.0 * cross, 0.0)


def match_ratio_test(
    d1: torch.Tensor,
    d2: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
    mask2: Optional[torch.Tensor] = None,
    ratio_threshold: float = 0.8,
    max_matches: Optional[int] = None,
) -> MatchResult:
    """Lowe's ratio-test matching, asymmetric (queries = rows of d1): accept
    row i iff d_first / d_second <= ratio and the second-best distance is
    > 0; output sorted ascending by ratio, capacity ``max_matches``
    (default n1) with a validity mask. ``d1`` (B, n1, D) and ``d2``
    (B, n2, D) match B pairs with one kernel launch."""
    n1 = d1.shape[-2]
    cap = min(max_matches, n1) if max_matches is not None else n1

    sq1, sq2, nearest = match_top2_fused(d1, d2, mask2)
    dist1 = torch.sqrt(sq1)
    dist2 = torch.sqrt(sq2)

    ratio = dist1 / torch.clamp_min(dist2, 1e-12)
    ok = (dist2 > 0) & (ratio <= ratio_threshold) & (dist2 < _BIG ** 0.5 - 1)
    if mask1 is not None:
        ok = ok & mask1

    # Sort best-first over fixed capacity; a stable sort puts the lower index
    # first among ties, as lax.top_k does.
    sort_key = torch.where(ok, ratio, float("inf"))
    order_key, order = torch.sort(sort_key, dim=-1, stable=True)
    order_key, rows = order_key[..., :cap], order[..., :cap]
    out_mask = torch.isfinite(order_key)
    indices = torch.stack([rows.int(), torch.gather(nearest, -1, rows)], dim=-1)
    confidence = torch.where(out_mask, torch.gather(ratio, -1, rows), 0.0)
    indices = torch.where(out_mask[..., None], indices, 0)
    return MatchResult(indices=indices.int(), confidence=confidence, mask=out_mask)


def match_pairs_batch(
    descriptors: torch.Tensor,   # (C, K, D) per-image descriptor stacks
    kp_mask: torch.Tensor,       # (C, K) bool valid-keypoint masks
    kp_xf: torch.Tensor,         # (C, K) subpixel x per image
    kp_yf: torch.Tensor,         # (C, K) subpixel y per image
    pair_i: torch.Tensor,        # (B,) first image index per pair
    pair_j: torch.Tensor,        # (B,) second image index per pair
    ratio_threshold: float = 0.8,
    max_matches: Optional[int] = None,
) -> Tuple[MatchResult, torch.Tensor, torch.Tensor]:
    """Ratio-test matching of B image pairs with one launch of the matcher
    kernel. Returns ``(MatchResult with (B, M, ...) leaves, p1, p2)``, where
    ``p1[b], p2[b]`` are the (M, 2) subpixel coordinates of pair b's
    matches."""
    pair_i = pair_i.long()
    pair_j = pair_j.long()
    res = match_ratio_test(
        descriptors[pair_i], descriptors[pair_j], kp_mask[pair_i], kp_mask[pair_j],
        ratio_threshold=ratio_threshold, max_matches=max_matches,
    )
    idx1 = res.indices[..., 0].long()
    idx2 = res.indices[..., 1].long()

    def take(coord, pk, idx):
        return torch.gather(coord[pk], 1, idx)

    p1 = torch.stack([take(kp_xf, pair_i, idx1), take(kp_yf, pair_i, idx1)], -1)
    p2 = torch.stack([take(kp_xf, pair_j, idx2), take(kp_yf, pair_j, idx2)], -1)
    return res, p1.float(), p2.float()
