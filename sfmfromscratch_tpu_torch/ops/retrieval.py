"""Image retrieval for pair selection: VLAD over a k-means descriptor
vocabulary (counterpart of ``sfmfromscratch_tpu/ops/retrieval.py``).

Descriptors are assigned to a small visual vocabulary and each image
aggregates its per-cluster residuals (VLAD, Jegou et al.); the embeddings
are power- and L2-normalised and ranked by cosine similarity. Every step is a
batched matmul, argmin or ``index_add_`` on the device, in float32 with TF32
off.
"""

from __future__ import annotations

from typing import Optional

import torch

from sfmfromscratch_tpu_torch.utils.precision import mm_f32

__all__ = ["kmeans_vocabulary", "vlad_embeddings", "retrieval_similarity"]


@mm_f32
def kmeans_vocabulary(
    generator: Optional[torch.Generator],
    descs: torch.Tensor,      # (C, K, D) per-image descriptors
    mask: torch.Tensor,       # (C, K) validity
    num_clusters: int = 64,
    iters: int = 8,
    scores: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(V, D) visual vocabulary by Lloyd's k-means over the valid
    descriptors. The centres start at the valid descriptors of the top-V
    uniform scores (invalid slots pushed down by 1e9); ``scores`` replaces
    the draw from ``generator`` (a test feeds the JAX package's). A cluster
    left empty keeps its centre."""
    C, K, D = descs.shape
    flat = descs.reshape(C * K, D)
    m = mask.reshape(C * K)
    if scores is None:
        scores = torch.rand((C * K,), generator=generator, device=descs.device,
                            dtype=descs.dtype)
    scores = scores - (~m).to(descs.dtype) * 1e9
    idx = torch.topk(scores, num_clusters).indices
    centers = flat[idx]
    w = m.to(flat.dtype)
    fsq = torch.sum(flat * flat, dim=1, keepdim=True)
    for _ in range(iters):
        d2 = fsq - 2.0 * flat @ centers.T + torch.sum(centers * centers, dim=1)[None, :]
        assign = torch.argmin(d2, dim=1)
        sums = flat.new_zeros((num_clusters, D)).index_add_(0, assign, flat * w[:, None])
        cnts = flat.new_zeros((num_clusters,)).index_add_(0, assign, w)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        centers = torch.where((cnts > 0)[:, None], new, centers)
    return centers


@mm_f32
def vlad_embeddings(
    descs: torch.Tensor,      # (C, K, D)
    mask: torch.Tensor,       # (C, K)
    centers: torch.Tensor,    # (V, D)
) -> torch.Tensor:
    """(C, V*D) VLAD embeddings: per-cluster residual sums of the valid
    descriptors, signed square root, then L2 normalisation (floor 1e-9)."""
    C, K, D = descs.shape
    V = centers.shape[0]
    d2 = (torch.sum(descs * descs, dim=-1, keepdim=True)
          - 2.0 * descs @ centers.T
          + torch.sum(centers * centers, dim=1)[None, None, :])       # (C, K, V)
    assign = torch.argmin(d2, dim=-1)                                   # (C, K)
    onehot = torch.nn.functional.one_hot(assign, V).to(descs.dtype)
    onehot = onehot * mask[..., None].to(descs.dtype)
    agg = torch.einsum("ckv,ckd->cvd", onehot, descs)                   # sums per cluster
    cnt = torch.sum(onehot, dim=1)                                      # (C, V)
    vlad = agg - cnt[..., None] * centers[None]                         # residuals
    flat = vlad.reshape(C, V * D)
    flat = torch.sign(flat) * torch.sqrt(torch.abs(flat))
    n = torch.linalg.norm(flat, dim=1, keepdim=True)
    return flat / torch.clamp_min(n, 1e-9)


@mm_f32
def retrieval_similarity(
    generator: Optional[torch.Generator], descs: torch.Tensor, mask: torch.Tensor,
    num_clusters: int = 64, scores: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(C, C) cosine similarity of VLAD embeddings minus 3 I: the diagonal
    lies below every real or masked value (cosine >= -1, mask floor -2), so
    no image proposes itself even when k exceeds the candidates."""
    centers = kmeans_vocabulary(generator, descs, mask, num_clusters=num_clusters,
                                scores=scores)
    emb = vlad_embeddings(descs, mask, centers)
    S = emb @ emb.T
    return S - 3.0 * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
