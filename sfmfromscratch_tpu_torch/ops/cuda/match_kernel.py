"""Blocked top-2 descriptor matcher: wrapper of the CUDA kernel
``csrc/match_top2.cu``.

Replaces ``sfmfromscratch_tpu/ops/pallas/match_kernel.py::_match_kernel``
(K3): for every query descriptor, the nearest and second-nearest squared L2
distances and the nearest index, without writing the (n1, n2) distance
matrix to device memory.

Bound on the card: 2 * n1 * n2 * D flops per pair — 1.60 GFLOP at the main
path's 2499 x 2499 x 128, 24 us at the H100 SXM's 67 TFLOP/s FP32 rate — so
it is compute-bound. The kernel runs FP32 FMAs on CUDA cores (the JAX f32
arithmetic; no TF32 or bf16), register-tiles each 32-query block against
64-row database tiles staged through shared memory, and keeps the running
top-2 in registers. The Pallas kernel's ``bf16=True`` mode is not ported.

``match_top2_plain`` is the plain PyTorch version of the same function (full
relative-distance matrix plus a stable top-2); the wrapper runs it for CPU
tensors, launches the kernel for CUDA tensors, and never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sfmfromscratch_tpu_torch.utils.precision import f32_precision

__all__ = ["match_top2_fused", "match_top2_plain", "launches"]

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

_MASKED_SQNORM = 1e12   # ||b||^2 of a masked database row (match_kernel.py:161-164)
_SENTINEL = 1e30        # "no candidate yet" (match_kernel.py:49)


def _norms(d1: torch.Tensor, d2: torch.Tensor, mask2: Optional[torch.Tensor]):
    n1sq = torch.sum(d1 * d1, dim=-1)
    n2sq = torch.sum(d2 * d2, dim=-1)
    if mask2 is not None:
        n2sq = torch.where(mask2, n2sq, _MASKED_SQNORM)
    return n1sq, n2sq


def match_top2_plain(
    d1: torch.Tensor, d2: torch.Tensor, n2sq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel core, plain: (B, n1, D), (B, n2, D), (B, n2) -> relative best,
    second-best (``||b||^2 - 2 a.b``) and the best index, ties to the lowest
    index. Materialises the (B, n1, n2) matrix."""
    with f32_precision():
        cur = n2sq[:, None, :] - 2.0 * torch.bmm(d1, d2.transpose(1, 2))
    vals, order = torch.sort(cur, dim=-1, stable=True)
    b1 = vals[..., 0]
    if cur.shape[-1] > 1:
        b2 = vals[..., 1]
    else:
        b2 = torch.full_like(b1, _SENTINEL)
    return b1, b2, order[..., 0].int()


def _launch(d1: torch.Tensor, d2: torch.Tensor, n2sq: torch.Tensor):
    """Launch the kernel on contiguous float32 CUDA tensors (B, n1, D),
    (B, n2, D), (B, n2)."""
    global launches
    from sfmfromscratch_tpu_torch.ops.cuda.build import load

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
    lib = load("match_top2")
    fn = lib.sfm_match_top2
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = fn(d1.data_ptr(), d2.data_ptr(), n2sq.data_ptr(), dist1.data_ptr(),
                 dist2.data_ptr(), idx.data_ptr(), B, n1, n2, D, stream)
    if err != 0:
        raise RuntimeError(f"match kernel launch failed with CUDA error {err}")
    launches += 1
    return dist1, dist2, idx


def match_top2_fused(
    d1: torch.Tensor, d2: torch.Tensor, mask2: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sq1, sq2, idx): per-query nearest and second-nearest squared
    distances (including ``||a||^2``, clamped at 0) and the nearest index.

    d1: (n1, D) or (B, n1, D) queries; d2: (n2, D) or (B, n2, D) database;
    mask2: (n2,) or (B, n2) bool, masked rows excluded. CUDA tensors go
    through the kernel, CPU tensors through ``match_top2_plain``.
    """
    single = d1.dim() == 2
    if single:
        d1, d2 = d1[None], d2[None]
        mask2 = None if mask2 is None else mask2[None]
    n1sq, n2sq = _norms(d1, d2, mask2)
    if d1.device.type == "cpu":
        r1, r2, idx = match_top2_plain(d1, d2, n2sq)
    elif d1.device.type == "cuda":
        r1, r2, idx = _launch(d1.contiguous(), d2.contiguous(), n2sq.contiguous())
    else:
        raise ValueError(f"unsupported device {d1.device}")
    sq1 = torch.clamp_min(r1 + n1sq, 0.0)
    sq2 = torch.clamp_min(r2 + n1sq, 0.0)
    if single:
        return sq1[0], sq2[0], idx[0]
    return sq1, sq2, idx
