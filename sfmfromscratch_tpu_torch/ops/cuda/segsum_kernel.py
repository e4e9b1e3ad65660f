"""Segment sums over a plan built once: wrapper of the CUDA kernel
``csrc/segment_sum.cu``.

Replaces no Pallas kernel: the JAX package leaves ``jax.ops.segment_sum`` to
XLA's scatter. Sums on the card add in a fixed order, never with atomics;
their index vectors stay fixed through a solve while the sums repeat, so the
kernel takes the plan that ``ba/schur.py::segment_plan`` builds once per
index vector and writes every segment's sum in one launch, in an order that
the plan fixes (``csrc/segment_sum.cu`` has the design).

Bound on the card: the rows, their places in the plan and the sums, moved
once, at 3.35 TB/s (``segsum_bytes``); a BA call at ``kf150_video``'s shapes
moves under 1 MB, so the launch sets its time. Rows are float32, the port's
precision, or float64, which the sharded BA's check on the card solves in.

Callers: ``ba/schur.py::segment_sum``, every segment sum of the port, each
with its plan: bundle adjustment (``ba/lm_core.py::lm_run`` plans once per
solve), motion averaging (``geometry/averaging.py``), triangulation
(``geometry/triangulation.py::triangulate_multiview``) and the chain
refresh's scale solve (``pipeline/chain_refresh.py::_solve_scales_cg``).

``segsum_plain`` is the plain PyTorch version (``index_add_``): the wrapper
runs it for CPU tensors, launches the kernel for CUDA tensors, and never
falls back.
"""

from __future__ import annotations

import ctypes

import torch

from sfmfromscratch_tpu_torch.ops.cuda.build import bind

__all__ = ["segment_sum_planned", "segsum_plain", "segsum_bytes", "WIDTHS", "LONG_ROWS",
           "ROWS_PER_LANE", "launches", "rows"]

# Launches of the CUDA kernel, and the rows they summed, since the last
# reset (set to 0 to reset).
launches = 0
rows = 0

# Row widths the kernel is built for: scalars, the 3-, 6-, 3x3-, 4x4-, 3x6-
# and 6x6-blocks.
WIDTHS = (1, 3, 6, 9, 16, 18, 36)
# Segments of more than LONG_ROWS rows get a block of 256 threads each (the
# kernel's constant of the same name); every other segment gets a group of
# lanes, enough for at most ROWS_PER_LANE rows a lane.
LONG_ROWS = 256
ROWS_PER_LANE = 8

_segment_sum = bind("segment_sum", "sfm_segment_sum",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def segsum_bytes(num_rows: int, width: int, num_segments: int) -> int:
    """Device memory traffic of one float32 call: the rows and their int32
    places in ``perm`` read once, the sums and the segment offsets once."""
    return 4 * (num_rows * (width + 1) + num_segments * (width + 1) + 1)


def segsum_plain(x: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(S, F) sums of the rows of ``x`` (O, F) by segment ``idx`` (O,)."""
    return x.new_zeros((num_segments,) + tuple(x.shape[1:])).index_add_(0, idx, x)


def _launch(x: torch.Tensor, plan) -> torch.Tensor:
    """One launch over every segment of ``plan`` for float32 or float64 rows
    ``x`` (O, F), F in ``WIDTHS``, contiguous."""
    global launches, rows

    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 2 or x.shape[1] not in WIDTHS:
        raise ValueError(f"segment-sum kernel takes float32 or float64 (O, F) rows with F in "
                         f"{WIDTHS}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("segment-sum kernel takes contiguous rows")
    index = (plan.perm, plan.offsets, plan.long_segs)
    if any(t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
           or t.device != x.device for t in index):
        raise ValueError("segment-sum plan: perm, offsets and long_segs must be contiguous "
                         "int32 vectors on the rows' device")
    S = plan.offsets.numel() - 1
    if plan.perm.numel() != x.shape[0] or S < 1 or plan.long_segs.numel() > S:
        raise ValueError(f"segment-sum plan of {plan.perm.numel()} rows and {S} segments "
                         f"for rows {tuple(x.shape)}")
    group = plan.group
    if not (1 <= group <= 32 and group & (group - 1) == 0):
        raise ValueError(f"segment-sum plan: group {group} is not a power of two up to 32")
    out = torch.empty((S, x.shape[1]), dtype=x.dtype, device=x.device)
    _segment_sum(x.device, x.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
                 plan.long_segs.data_ptr(), S, plan.long_segs.numel(), group, x.shape[1],
                 x.element_size(), out.data_ptr())
    launches += 1
    rows += x.shape[0]
    return out


def segment_sum_planned(x: torch.Tensor, plan) -> torch.Tensor:
    """(S, F) segment sums of rows ``x`` (O, F) over ``plan``
    (``ba/schur.py::SegmentPlan``): the kernel for CUDA tensors,
    ``segsum_plain`` over the plan's indices for CPU tensors."""
    if x.device.type == "cpu":
        return segsum_plain(x, plan.idx, plan.offsets.numel() - 1)
    if x.device.type == "cuda":
        return _launch(x, plan)
    raise ValueError(f"unsupported device {x.device}")
