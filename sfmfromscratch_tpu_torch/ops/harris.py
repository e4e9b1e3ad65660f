"""Harris corner detection (counterpart of ``sfmfromscratch_tpu/ops/harris.py``).

``harris_response`` is the plain PyTorch version of the fused CUDA kernel in
``ops/cuda/harris_kernel.py``; ``detect_harris_keypoints`` always goes
through that kernel's wrapper, which launches the kernel for CUDA tensors and
runs ``harris_response`` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.image import conv2d_same, gaussian_kernel, sobel_gradients
from sfmfromscratch_tpu_torch.types import Keypoints


def harris_response(
    image: torch.Tensor, gaussian_size: int, sigma: float, alpha: float
) -> torch.Tensor:
    """Harris corner response map R = det(M) - alpha * trace(M)^2 of a
    (..., H, W) image (reference NaiveSIFT.py:60-74)."""
    Ix, Iy = sobel_gradients(image)
    g = gaussian_kernel(gaussian_size, sigma, dtype=image.dtype, device=image.device)
    Sxx = conv2d_same(Ix * Ix, g)
    Sxy = conv2d_same(Ix * Iy, g)
    Syy = conv2d_same(Iy * Iy, g)
    det = Sxx * Syy - Sxy * Sxy
    trace = Sxx + Syy
    return det - alpha * trace * trace


def _window_max(R: torch.Tensor, ksize: int) -> torch.Tensor:
    """Per-pixel max over a (2*(ksize//2)+1)^2 neighborhood of (..., H, W)
    maps; ``max_pool2d`` pads with -inf like the JAX ``reduce_window``."""
    half = ksize // 2
    win = 2 * half + 1
    H, W = R.shape[-2:]
    out = F.max_pool2d(R.reshape(-1, 1, H, W), win, stride=1, padding=half)
    return out.reshape(R.shape)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of each (H, W) map of a (..., H, W) stack: the mean of
    the two middle values for an even count (``torch.median`` returns the
    lower one)."""
    flat = x.reshape(x.shape[:-2] + (-1,))
    n = flat.shape[-1]
    hi = torch.kthvalue(flat, n // 2 + 1, dim=-1).values
    if n % 2:
        return hi
    lo = torch.kthvalue(flat, n // 2, dim=-1).values
    return lo * 0.5 + hi * 0.5


def detect_harris_keypoints(
    image: torch.Tensor,
    k: int,
    feature_width: int,
    nms_ksize: int,
    gaussian_size: int,
    sigma: float,
    alpha: float,
) -> Keypoints:
    """Top-k Harris keypoints of a (H, W) image or of each image of a
    (B, H, W) stack (one kernel launch for the stack), fixed capacity k with
    mask, sorted by descending response (reference NaiveSIFT.py:54-120)."""
    from sfmfromscratch_tpu_torch.ops.cuda.harris_kernel import harris_response_fused

    single = image.dim() == 2
    if single:
        image = image[None]
    B, H, W = image.shape
    R = harris_response_fused(image, gaussian_size, sigma, alpha)
    Rmax = _window_max(R, nms_ksize)
    median = _median(R)
    is_local_max = (R == Rmax) & (R >= median[:, None, None])

    half = feature_width // 2
    rows = torch.arange(H, device=R.device)[:, None]
    cols = torch.arange(W, device=R.device)[None, :]
    in_bounds = (rows >= half) & (rows < H - half) & (cols >= half) & (cols < W - half)

    candidate = is_local_max & in_bounds
    neg_inf = float("-inf")
    score = torch.where(candidate, R, neg_inf).reshape(B, -1)
    # lax.top_k breaks ties toward the lower index; a stable descending sort
    # does the same (torch.topk promises no tie order).
    k_eff = min(k, score.shape[-1])
    top_scores, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k_eff], top_idx[:, :k_eff]
    if k_eff < k:
        top_scores = torch.cat([top_scores, score.new_full((B, k - k_eff), neg_inf)], dim=-1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((B, k - k_eff))], dim=-1)
    y = top_idx // W
    x = top_idx % W
    mask = top_scores > neg_inf

    # Subpixel peak: 1-D parabola fit through the response along each axis.
    b = torch.arange(B, device=R.device)[:, None]
    yc = y.clamp(1, H - 2)
    xc = x.clamp(1, W - 2)
    c = R[b, yc, xc]
    dx_num = R[b, yc, xc - 1] - R[b, yc, xc + 1]
    dx_den = 2.0 * (R[b, yc, xc - 1] - 2.0 * c + R[b, yc, xc + 1])
    dy_num = R[b, yc - 1, xc] - R[b, yc + 1, xc]
    dy_den = 2.0 * (R[b, yc - 1, xc] - 2.0 * c + R[b, yc + 1, xc])
    dx = (dx_num / torch.where(dx_den.abs() < 1e-12, 1e-12, dx_den)).clamp(-0.5, 0.5)
    dy = (dy_num / torch.where(dy_den.abs() < 1e-12, 1e-12, dy_den)).clamp(-0.5, 0.5)
    xf = x.float() + torch.where(mask, dx, 0.0)
    yf = y.float() + torch.where(mask, dy, 0.0)
    kps = Keypoints(
        x=x.int(), y=y.int(), score=torch.where(mask, top_scores, 0.0),
        mask=mask, xf=xf, yf=yf,
    )
    return Keypoints(*(v[0] for v in kps)) if single else kps
