"""Blocked top-2 descriptor matcher: wrapper of the CUDA kernel
``csrc/match_top2.cu``.

Replaces ``sfmfromscratch_tpu/ops/pallas/match_kernel.py::_match_kernel``
(K3), in both of its modes: for every query descriptor, the nearest and
second-nearest squared L2 distances and the nearest index, without writing
the (n1, n2) distance matrix to device memory.

Bound on the card: 2 * n1 * n2 * D flops per pair. The f32 mode (the JAX
float32 arithmetic: FP32 FMA on CUDA cores, no TF32) is bound by the FP32
rate, 0.215 ms for the engine's 9 pairs of 2499 x 2499 x 128 at 67 TFLOP/s.
The ``bf16=True`` mode rounds both operands to bfloat16 and sums their
products in float32 on the tensor cores (``mma.sync``); there the top-2
epilogue on the CUDA cores and the database reads set the pace. Both keep
128 queries resident per block, stream 128-row database tiles, keep a
running top-2 in registers, and split the database walk across blocks when
the batch alone would leave SMs idle (a second small kernel merges the
segments; one call still counts one launch).

``match_top2_plain`` is the plain PyTorch version of the same function (full
relative-distance matrix plus a stable top-2); the wrapper runs it for CPU
tensors, launches the kernel for CUDA tensors, and never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.cuda.build import bind
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

__all__ = ["match_top2_fused", "match_top2_plain", "launches", "launches_bf16"]

# Launches of the CUDA kernel since the last reset (set to 0 to reset): f32
# mode in ``launches``, bf16 mode in ``launches_bf16``.
launches = 0
launches_bf16 = 0

_MASKED_SQNORM = 1e12   # ||b||^2 of a masked database row (match_kernel.py:161-164)
_SENTINEL = 1e30        # "no candidate yet" (match_kernel.py:49)
_KC = 32                # the kernel takes D in multiples of 32 (zero-padded here)
_MAX_SEGMENTS = 16      # most segments a database walk is split into

_match = bind("match_top2", "sfm_match_top2", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7)


def _norms(d1: torch.Tensor, d2: torch.Tensor, mask2: Optional[torch.Tensor]):
    n1sq = torch.sum(d1 * d1, dim=-1)
    n2sq = torch.sum(d2 * d2, dim=-1)
    if mask2 is not None:
        n2sq = torch.where(mask2, n2sq, _MASKED_SQNORM)
    return n1sq, n2sq


def match_top2_plain(
    d1: torch.Tensor, d2: torch.Tensor, n2sq: torch.Tensor, bf16: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel core, plain: (B, n1, D), (B, n2, D), (B, n2) -> relative best,
    second-best (``||b||^2 - 2 a.b``) and the best index, ties to the lowest
    index. Materialises the (B, n1, n2) matrix. ``bf16`` rounds ``d1`` and
    ``d2`` to bfloat16 first and multiplies in float32: a product of two
    bfloat16 values is exact in float32, so only the order of the sum
    differs from the kernel's."""
    if bf16:
        d1 = d1.to(torch.bfloat16).float()
        d2 = d2.to(torch.bfloat16).float()
    with f32_precision():
        cur = n2sq[:, None, :] - 2.0 * torch.bmm(d1, d2.transpose(1, 2))
    vals, order = torch.sort(cur, dim=-1, stable=True)
    b1 = vals[..., 0]
    if cur.shape[-1] > 1:
        b2 = vals[..., 1]
    else:
        b2 = torch.full_like(b1, _SENTINEL)
    return b1, b2, order[..., 0].int()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data start on 16 bytes (the kernel's vector
    loads), else a contiguous copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(d1: torch.Tensor, d2: torch.Tensor, n2sq: torch.Tensor, bf16: bool = False):
    """Launch the kernel on contiguous float32 CUDA tensors (B, n1, D),
    (B, n2, D), (B, n2); ``bf16`` selects the bf16 mode."""
    global launches, launches_bf16

    for t in (d1, d2, n2sq):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != d1.device:
            raise ValueError("match kernel takes contiguous float32 tensors on one device")
    B, n1, D = d1.shape
    if d2.dim() != 3 or d2.shape[0] != B or d2.shape[2] != D or n2sq.shape != d2.shape[:2]:
        raise ValueError(f"shape mismatch: d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)}, "
                         f"n2sq {tuple(n2sq.shape)}")
    n2 = d2.shape[1]
    dist1 = torch.empty((B, n1), dtype=torch.float32, device=d1.device)
    dist2 = torch.empty_like(dist1)
    idx = torch.empty((B, n1), dtype=torch.int32, device=d1.device)
    if n1 == 0:
        return dist1, dist2, idx
    if n2 == 0 or D == 0:
        raise ValueError("match kernel needs a non-empty database and descriptor width")
    if D % _KC:
        # Zero columns add nothing to a.b.
        pad = _KC - D % _KC
        d1, d2 = F.pad(d1, (0, pad)), F.pad(d2, (0, pad))
        D += pad
    d1, d2, n2sq = _aligned(d1), _aligned(d2), _aligned(n2sq)
    scratch = torch.empty((3 * B * _MAX_SEGMENTS * n1,), dtype=torch.float32, device=d1.device)
    _match(d1.device, d1.data_ptr(), d2.data_ptr(), n2sq.data_ptr(), dist1.data_ptr(),
           dist2.data_ptr(), idx.data_ptr(), scratch.data_ptr(), B, n1, n2, D, int(bf16), 0,
           _MAX_SEGMENTS)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return dist1, dist2, idx


def match_top2_fused(
    d1: torch.Tensor, d2: torch.Tensor, mask2: Optional[torch.Tensor] = None,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sq1, sq2, idx): per-query nearest and second-nearest squared
    distances (including ``||a||^2``, clamped at 0) and the nearest index.

    d1: (n1, D) or (B, n1, D) queries; d2: (n2, D) or (B, n2, D) database;
    mask2: (n2,) or (B, n2) bool, masked rows excluded. ``bf16`` takes the
    cross term from bfloat16-rounded descriptors, summed in float32, as the
    JAX ``match_top2_fused(..., bf16=True)``; the norms stay float32. CUDA
    tensors go through the kernel, CPU tensors through ``match_top2_plain``.
    """
    single = d1.dim() == 2
    if single:
        d1, d2 = d1[None], d2[None]
        mask2 = None if mask2 is None else mask2[None]
    n1sq, n2sq = _norms(d1, d2, mask2)
    if d1.device.type == "cpu":
        r1, r2, idx = match_top2_plain(d1, d2, n2sq, bf16)
    elif d1.device.type == "cuda":
        r1, r2, idx = _launch(d1.contiguous(), d2.contiguous(), n2sq.contiguous(), bf16)
    else:
        raise ValueError(f"unsupported device {d1.device}")
    sq1 = torch.clamp_min(r1 + n1sq, 0.0)
    sq2 = torch.clamp_min(r2 + n1sq, 0.0)
    if single:
        return sq1[0], sq2[0], idx[0]
    return sq1, sq2, idx
