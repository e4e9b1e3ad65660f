"""Image preprocessing ops: grayscale, resize, pyramids, 2-D convolution
(counterpart of ``sfmfromscratch_tpu/ops/image.py``).

Convolutions are zero-padded cross-correlations (``F.conv2d``), matching
cv2.filter2D(..., borderType=cv2.BORDER_CONSTANT), and run with TF32 off.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.utils.precision import f32_precision

# OpenCV grayscale coefficients (reference Runner.py:467-478).
_GRAY_COEFFS = (0.299, 0.587, 0.114)

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB in [0,1] -> (..., H, W) grayscale, OpenCV weights."""
    return (
        img[..., 0] * _GRAY_COEFFS[0]
        + img[..., 1] * _GRAY_COEFFS[1]
        + img[..., 2] * _GRAY_COEFFS[2]
    )


def conv2d_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' cross-correlation of a (..., H, W) image with a
    (kh, kw) kernel — cv2.filter2D with BORDER_CONSTANT."""
    batch_shape = image.shape[:-2]
    H, W = image.shape[-2:]
    kh, kw = kernel.shape
    x = image.reshape(-1, 1, H, W)
    x = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    k = kernel.to(device=image.device, dtype=image.dtype).reshape(1, 1, kh, kw)
    with f32_precision():
        out = F.conv2d(x, k)
    return out.reshape(batch_shape + (H, W))


def gaussian_kernel(ksize: int, sigma, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 2-D Gaussian (reference NaiveSIFT.py:175-199)."""
    mean = ksize // 2
    axis = torch.as_tensor(np.linspace(-mean, mean, ksize), dtype=dtype, device=device)
    r2 = axis[:, None] ** 2 + axis[None, :] ** 2
    s = torch.as_tensor(sigma, dtype=dtype, device=device)
    g2 = torch.exp(-r2 / (2.0 * s ** 2))
    return g2 / torch.sum(g2)


def sobel_gradients(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) via 3x3 Sobel with zero-padded borders
    (reference NaiveSIFT.py:201-213)."""
    kx = torch.as_tensor(SOBEL_X, device=image.device)
    ky = torch.as_tensor(SOBEL_Y, device=image.device)
    return conv2d_same(image, kx), conv2d_same(image, ky)


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centers. ``jax.image.resize(...,
    "linear")`` antialiases when it downscales, so this does too."""
    batch_shape = image.shape[:-2]
    H, W = image.shape[-2:]
    x = image.reshape(-1, 1, H, W)
    out = F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=True
    )
    return out.reshape(batch_shape + tuple(out_hw))


def pyramid_shapes(hw: Tuple[int, int], num_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (H, W) following the reference's chained int division
    (ScaleRotInvSIFT.py:109-115)."""
    shapes = [tuple(hw)]
    for _ in range(1, num_levels):
        h, w = shapes[-1]
        shapes.append((int(h / scale_factor), int(w / scale_factor)))
    return shapes


def build_pyramid(image: torch.Tensor, num_levels: int, scale_factor: float) -> List[torch.Tensor]:
    """Image pyramid; level i+1 resized from level i (not from level 0)."""
    levels = [image]
    shapes = pyramid_shapes(tuple(image.shape[-2:]), num_levels, scale_factor)
    for hw in shapes[1:]:
        levels.append(resize_bilinear(levels[-1], hw))
    return levels
