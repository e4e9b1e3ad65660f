"""Fused Harris response: wrapper of the CUDA kernel ``csrc/harris.cu``.

Replaces ``sfmfromscratch_tpu/ops/pallas/harris_kernel.py``: both its
whole-image kernel (``_harris_kernel``, K1) and its row-tiled halo kernel
(``_harris_tiled_kernel``, K2) become one 2-D tiled kernel, because Hopper has
no 12 MB VMEM gate to route around. The entry point keeps its name,
``harris_response_fused``.

Bound on the card: one f32 read and one f32 write per pixel (8 B/pixel:
13.8 MB for the engine's 10 images at 360x480, 4.1 us at 3.35 TB/s), so the
kernel is bound by bytes. It stages each 32 x 64 tile plus its halo in shared
memory once, keeps all five intermediate maps there, and unrolls its tap
loops (the Gaussian size is a template parameter of the kernel), so device
memory sees only the image read and the response write. A call's host path
is kept short: the library's argument types are set once, the taps are
cached per (gaussian_size, sigma), and no device context is entered when the
tensor's device is already current.

The plain PyTorch version of the same function is ``harris_response``
(``ops/harris.py``): the wrapper runs it for CPU tensors, launches the kernel
for CUDA tensors, and never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ops.harris import harris_response

__all__ = ["harris_response", "harris_response_fused", "gaussian_taps", "cached_taps",
           "launches"]

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

MAX_TAPS = 31

_fn = None      # sfm_harris_response, argument types set once at load
_taps = {}      # (gaussian_size, sigma) -> (float32 taps, their address)


def gaussian_taps(gaussian_size: int, sigma: float) -> np.ndarray:
    """1-D factor of the normalised 2-D Gaussian, computed as the Pallas
    kernel computes it (harris_kernel.py:95-98): float64 linspace cast to
    float32, then exp and normalise in float32."""
    mean = gaussian_size // 2
    axis = np.linspace(-mean, mean, gaussian_size).astype(np.float32)
    s = np.float32(sigma)
    e = np.exp(-(axis ** 2) / (np.float32(2.0) * s ** 2)).astype(np.float32)
    return (e / np.sum(e, dtype=np.float32)).astype(np.float32)


def cached_taps(gaussian_size: int, sigma: float):
    """(``gaussian_taps(gaussian_size, sigma)``, the address of its first
    float), computed once per (gaussian_size, sigma) and kept alive for the
    kernel's reads. Raises for a size the kernel has no instance of (even,
    or outside 1..31)."""
    key = (gaussian_size, sigma)
    entry = _taps.get(key)
    if entry is None:
        if not (1 <= gaussian_size <= MAX_TAPS and gaussian_size % 2 == 1):
            raise ValueError(f"gaussian_size must be odd and at most {MAX_TAPS}, "
                             f"got {gaussian_size}")
        taps = gaussian_taps(gaussian_size, sigma)
        entry = _taps[key] = (taps, taps.ctypes.data)
    return entry


def _kernel():
    """``sfm_harris_response`` from the built library, argument types set once."""
    global _fn
    if _fn is None:
        from sfmfromscratch_tpu_torch.ops.cuda.build import load

        fn = load("harris").sfm_harris_response
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(images: torch.Tensor, gaussian_size: int, sigma: float, alpha: float) -> torch.Tensor:
    """Launch the kernel on a (B, H, W) float32 CUDA tensor."""
    global launches

    if images.dtype != torch.float32 or images.dim() != 3 or not images.is_contiguous():
        raise ValueError("harris kernel takes a contiguous (B, H, W) float32 tensor")
    _, taps_ptr = cached_taps(gaussian_size, sigma)
    B, H, W = images.shape
    out = torch.empty_like(images)
    if images.numel() == 0:
        return out
    fn = _kernel()
    args = (images.data_ptr(), out.data_ptr(), taps_ptr, gaussian_size, alpha, B, H, W)
    dev = images.device.index
    if dev == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"harris kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def harris_response_fused(
    image: torch.Tensor, gaussian_size: int, sigma: float, alpha: float
) -> torch.Tensor:
    """Harris response of a (H, W) or (B, H, W) float32 image.

    CUDA tensors go through the kernel (which raises if it cannot build or
    launch); CPU tensors through the plain ``harris_response``.
    """
    if image.device.type == "cpu":
        return harris_response(image, gaussian_size, sigma, alpha)
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    if image.dim() == 2:
        return _launch(image[None].contiguous(), gaussian_size, sigma, alpha)[0]
    return _launch(image.contiguous(), gaussian_size, sigma, alpha)
