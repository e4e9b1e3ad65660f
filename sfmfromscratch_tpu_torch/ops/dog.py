"""Difference-of-Gaussians scale-space keypoint detector (counterpart of
``sfmfromscratch_tpu/ops/dog.py``).

A Gaussian stack of one octave, DoG extrema over (x, y, scale) by 3-D max
pooling, Lowe's contrast and edge-response gates, and a fixed-capacity
top-k. Plain PyTorch: the JAX module has no Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.image import conv2d_same, gaussian_kernel
from sfmfromscratch_tpu_torch.types import Keypoints


def _gaussian_stack(image: torch.Tensor, sigmas) -> torch.Tensor:
    """(S, H, W) Gaussian-blurred images at the given sigmas (kernels of
    2 ceil(3 sigma) + 1 taps, zero-padded)."""
    outs = []
    for s in sigmas:
        ksize = int(2 * math.ceil(3 * s) + 1)
        outs.append(conv2d_same(image, gaussian_kernel(ksize, s, dtype=image.dtype,
                                                       device=image.device)))
    return torch.stack(outs)


def top_k_stable(score: torch.Tensor, k: int):
    """The ``k`` largest entries of a 1-D ``score`` and their indices, equal
    scores in index order: ``lax.top_k``'s order, which ``torch.topk`` does
    not promise on the card."""
    top, idx = torch.sort(score, descending=True, stable=True)
    return top[:k], idx[:k]


def detect_dog_keypoints(
    image: torch.Tensor,
    k: int,
    num_scales: int = 4,
    base_sigma: float = 1.6,
    contrast_threshold: float = 0.015,
    edge_threshold: float = 10.0,
    border: int = 8,
) -> Keypoints:
    """Top-k DoG extrema of one (H, W) image with contrast and edge gating
    (``dog.py:34-98``). Returns fixed-capacity ``Keypoints`` whose score is
    the |DoG| response; the scale folds into the ranking only. Slots past
    the last candidate are masked and carry arbitrary coordinates."""
    H, W = image.shape
    kfac = 2.0 ** (1.0 / max(num_scales - 1, 1))
    sigmas = [base_sigma * (kfac ** i) for i in range(num_scales + 2)]
    G = _gaussian_stack(image, sigmas)              # (S+2, H, W)
    D = G[1:] - G[:-1]                              # (S+1, H, W) DoG planes

    # 3x3x3 extrema; max pooling pads with -inf as reduce_window's init.
    pool = lambda x: F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = D == pool(D)
    is_min = D == -pool(-D)
    resp = torch.abs(D)
    strong = resp > contrast_threshold

    # Edge gate: Hessian trace^2/det test on each DoG plane (Lowe 4.1).
    kern = lambda rows: torch.tensor(rows, dtype=D.dtype, device=D.device)
    Dxx = conv2d_same(D, kern([[1.0, -2.0, 1.0]]))
    Dyy = conv2d_same(D, kern([[1.0], [-2.0], [1.0]]))
    Dxy = conv2d_same(D, kern([[0.25, 0, -0.25], [0, 0, 0], [-0.25, 0, 0.25]]))
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    rows = torch.arange(H, device=D.device)[None, :, None]
    cols = torch.arange(W, device=D.device)[None, None, :]
    in_b = (rows >= border) & (rows < H - border) & (cols >= border) & (cols < W - border)

    cand = (is_max | is_min) & strong & edge_ok & in_b
    score = torch.where(cand, resp, float("-inf")).reshape(-1)
    top, idx = top_k_stable(score, k)
    rem = idx % (H * W)
    y = (rem // W).to(torch.int32)
    x = (rem % W).to(torch.int32)
    mask = torch.isfinite(top)
    return Keypoints(x=x, y=y, score=torch.where(mask, top, 0.0), mask=mask,
                     xf=x.to(torch.float32), yf=y.to(torch.float32))
