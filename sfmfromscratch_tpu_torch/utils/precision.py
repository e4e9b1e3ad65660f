"""Scoped float32 precision for the geometry stack and the Sobel/SIFT
convolutions (counterpart of ``sfmfromscratch_tpu/utils/precision.py``).

On an NVIDIA card a float32 matmul may run in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set, and a float32 cuDNN
convolution runs in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True). TF32 keeps about three decimal digits, which epipolar geometry,
triangulation and the Harris/SIFT gradients amplify into pose error. ``mm_f32``
turns both flags off for the wrapped call and restores them afterwards.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["f32_precision", "mm_f32"]


@contextlib.contextmanager
def f32_precision():
    """Context in which float32 matmuls and convolutions run in full float32."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def mm_f32(fn):
    """Decorator: run ``fn`` inside :func:`f32_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_precision():
            return fn(*args, **kwargs)

    return wrapped
