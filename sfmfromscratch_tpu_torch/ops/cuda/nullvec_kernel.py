"""Batched null vector of 8x9 minimal systems: wrapper of the CUDA kernel
``csrc/nullvec_qr.cu``.

Replaces no Pallas kernel: the JAX package leaves this solve to XLA
(``sfmfromscratch_tpu/ops/smallsvd.py::nullvec_lstsq``, the complete QR of
``A^T``). On the card, ``torch.linalg.qr(A^T, mode="complete")`` runs
cuSOLVER's Householder product once per matrix, about 12 launches a system,
and the RANSAC filters solve one system a hypothesis. The kernel solves every
system of a call in one launch, one thread a system, with LAPACK's unblocked
Householder QR in float32 on the CUDA cores: the same vector, sign included,
to float32 rounding (``csrc/nullvec_qr.cu`` has the details).

Bound on the card: 324 bytes a system (72 floats in, 9 out) at 3.35 TB/s,
above ``NULLVEC_FLOPS`` a system at 67 TFLOP/s FP32; 0.097 ms for 1 M
systems.

Callers that reach it on the card, through ``ops/smallsvd.py::nullvec_lstsq``
(its ``m < n`` branch at ``(m, n) == (8, 9)``) and
``geometry/epipolar.py::eight_point_fundamental`` on minimal samples:

- ``geometry/ransac.py::ransac_essential_pose`` and its batch (fixed-count
  essential RANSAC: the two-view slice, the engine's pose recovery, and the
  bootstrap and the global relative poses with ``adaptive=False``);
- ``geometry/ransac.py::_fundamental_lanes`` (fixed-count and adaptive
  F-RANSAC: the F-filter of both engines, the global engine's window pairs
  and the keyframed registration's matches);
- ``geometry/ransac.py::ransac_essential_pose_adaptive_batch`` (the adaptive
  bootstrap, the global relative poses and their pair-sharded form);
- ``compat.py``'s ``eight_point_fundamental`` when given exactly 8 points.

The LO refit, ``pipeline/chain_refresh.py`` and the DLT and triangulation
null vectors solve systems of at least as many rows as columns and do not
reach it.

``nullvec_qr_plain`` is the plain PyTorch version (``torch.linalg.qr``): the
wrapper runs it for CPU tensors, launches the kernel for CUDA tensors, and
never falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sfmfromscratch_tpu_torch.ops.cuda.build import bind

__all__ = ["nullvec_8x9", "nullvec_qr_plain", "NULLVEC_BYTES", "NULLVEC_FLOPS",
           "launches", "systems"]

# Launches of the CUDA kernel, and the systems they solved, since the last
# reset (set to 0 to reset).
launches = 0
systems = 0

# Device memory traffic and floating-point operations of one system: the
# 8 x 9 input and the 9 outputs in float32; per reflector over a sub-column
# of x + 1 entries, its norm and scaling (3 x + 7), its update of the x - 1
# later columns (4 x + 2 each) and its step on Q's last column (4 x + 2);
# then that column's norm and division (27).
NULLVEC_BYTES = 4 * (8 * 9 + 9)
NULLVEC_FLOPS = sum(4 * x * x + 5 * x + 7 for x in range(1, 9)) + 27   # 1,079

_nullvec = bind("nullvec_qr", "sfm_nullvec_qr",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])


def nullvec_qr_plain(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector of (..., m, n) systems with m < n: the last column
    of the complete QR of A^T, normalised."""
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    v = Q[..., :, -1]
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _launch(A: torch.Tensor) -> torch.Tensor:
    """One launch over every system of a float32 (..., 8, 9) tensor: the
    leading dimensions are flattened into one batch."""
    global launches, systems

    if A.dtype != torch.float32 or A.dim() < 2 or tuple(A.shape[-2:]) != (8, 9):
        raise ValueError(f"nullvec kernel takes float32 (..., 8, 9) systems, got "
                         f"{A.dtype} {tuple(A.shape)}")
    lead = tuple(A.shape[:-2])
    count = math.prod(lead)
    out = torch.empty(lead + (9,), dtype=torch.float32, device=A.device)
    if count == 0:
        return out
    A = A.contiguous()
    _nullvec(A.device, A.data_ptr(), out.data_ptr(), count)
    launches += 1
    systems += count
    return out


@torch.library.custom_op("sfmfromscratch_tpu_torch::nullvec_8x9", mutates_args=())
def _nullvec_op(A: torch.Tensor) -> torch.Tensor:
    """The launch as a PyTorch operator, so that ``torch.func.vmap`` can
    batch it (the fixed-count relative poses vmap over pairs): a batched
    tensor has no data pointer to hand to the kernel."""
    return _launch(A)


@_nullvec_op.register_fake
def _(A):
    return A.new_empty(A.shape[:-2] + (9,))


@_nullvec_op.register_vmap
def _(info, in_dims, A):
    # The vmapped dimension becomes one more leading dimension of the one
    # launch.
    (dim,) = in_dims
    if dim is None:
        return _nullvec_op(A), None
    return _nullvec_op(A.movedim(dim, 0)), 0


def nullvec_8x9(A: torch.Tensor) -> torch.Tensor:
    """(..., 9) unit null vectors of (..., 8, 9) systems: the kernel for CUDA
    tensors (float32 only), ``nullvec_qr_plain`` for CPU tensors."""
    if A.device.type == "cpu":
        return nullvec_qr_plain(A)
    if A.device.type == "cuda":
        return _nullvec_op(A)
    raise ValueError(f"unsupported device {A.device}")
