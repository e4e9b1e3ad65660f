"""Tensor-parallel NN-ratio matching: the descriptor database sharded over
the ``model`` mesh axis (counterpart of
``sfmfromscratch_tpu/parallel/sharded_match.py``).

Each rank takes its contiguous block of database rows and finds every
query's local best and second-best squared distances with the matcher
kernel (``ops/cuda/match_kernel.py::match_top2_fused``, K3; its plain
version for CPU tensors), where the JAX shard computes ``pairwise_sq_dists``
and ``top_k(2)``: the same function. One ``all_gather`` of 2 candidates per
shard, and the global top-2 merges as in the JAX package: candidates in
shard order, the lower slot (the lower global index) first among ties.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from sfmfromscratch_tpu_torch.ops.cuda.match_kernel import match_top2_fused
from sfmfromscratch_tpu_torch.parallel.mesh import all_gather_cat, mesh_axis
from sfmfromscratch_tpu_torch.types import MatchResult

__all__ = ["tp_match_ratio_test"]

_BIG = 1e12


def tp_match_ratio_test(
    mesh: DeviceMesh,
    d1: torch.Tensor,
    d2: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
    mask2: Optional[torch.Tensor] = None,
    ratio_threshold: float = 0.8,
    axis: str = "model",
) -> MatchResult:
    """Lowe's ratio-test matching of queries ``d1`` (n1, D) against the
    database ``d2`` (n2, D) sharded along ``axis``, with the single-device
    ``match_ratio_test``'s result (capacity n1, best-first). ``n2`` must
    divide into shards of at least 2 rows, as ``shard_map`` and
    ``top_k(2)`` require."""
    ax = mesh_axis(mesh, axis)
    if ax is None:
        raise ValueError(f"the mesh has no {axis!r} axis")
    n1, n2 = d1.shape[0], d2.shape[0]
    if n2 % ax.size or n2 // ax.size < 2:
        raise ValueError(f"a database of {n2} rows does not split into {ax.size} shards "
                         "of 2 rows or more")
    if mask1 is None:
        mask1 = torch.ones((n1,), dtype=torch.bool, device=d1.device)
    if mask2 is None:
        mask2 = torch.ones((n2,), dtype=torch.bool, device=d1.device)
    shard = n2 // ax.size
    lo = ax.rank * shard
    sq1, sq2, idx = match_top2_fused(d1, d2[lo:lo + shard], mask2[lo:lo + shard])
    # The kernel masks through a database norm of 1e12, so a masked row's
    # distance is 1e12 plus a term of the descriptors' size; the JAX shard
    # writes exactly _BIG there.
    local = torch.stack([sq1, sq2], dim=-1)                              # (n1, 2)
    local = torch.where(local >= 0.5 * _BIG, _BIG, local)
    cand = all_gather_cat(local[None], ax)                               # (m, n1, 2)
    best = all_gather_cat((idx.to(torch.int64) + lo)[None], ax)          # (m, n1)
    m = cand.shape[0]
    cand = cand.permute(1, 0, 2).reshape(n1, 2 * m)
    # A stable ascending sort is top_k of the negated values: ties keep the
    # lower slot. The global best is always some shard's best (slot 2k).
    top, slot = torch.sort(cand, dim=-1, stable=True)
    nearest = torch.gather(best.T, 1, (slot[:, :1] // 2))[:, 0]
    d_first = torch.sqrt(torch.clamp_min(top[:, 0], 0.0))
    d_second = torch.sqrt(torch.clamp_min(top[:, 1], 0.0))
    ratio = d_first / torch.clamp_min(d_second, 1e-12)
    ok = (d_second > 0) & (ratio <= ratio_threshold) & (d_second < _BIG ** 0.5 - 1) & mask1
    sort_key = torch.where(ok, ratio, float("inf"))
    order_key, rows = torch.sort(sort_key, stable=True)
    out_mask = torch.isfinite(order_key)
    indices = torch.stack([rows, nearest[rows]], dim=-1).to(torch.int32)
    confidence = torch.where(out_mask, ratio[rows], 0.0)
    indices = torch.where(out_mask[:, None], indices, 0)
    return MatchResult(indices=indices, confidence=confidence, mask=out_mask)
