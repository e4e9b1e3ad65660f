"""Batched (Root)SIFT descriptors (counterpart of ``sfmfromscratch_tpu/ops/sift.py``).

All keypoints of an image, or of a stack of images, at once: patches are one
clamped index gather, the 36-bin dominant-orientation histogram and the
4x4x8 cell histograms are one-hot weighted batched matmuls. The JAX package has no kernel here (its Pallas SIFT
kernel lost to XLA and was deleted), so neither does the port.

Reference quirks kept: only the top-left 16x16 of the ``feature_width``
window feeds the 4x4 grid of 4-px cells; after dominant-orientation
subtraction, angles outside [-pi, pi] are dropped (np.histogram semantics,
ScaleRotInvSIFT.py:62-76); RootSIFT = L2-normalize then sqrt.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.image import SOBEL_X, SOBEL_Y, sobel_gradients
from sfmfromscratch_tpu_torch.utils.precision import mm_f32

_GRID = 4           # 4x4 spatial cells
_CELL = 4           # each cell is 4x4 pixels
_NBINS = 8          # orientation bins per cell
_DOM_BINS = 36      # dominant-orientation histogram bins
_DESC_REGION = _GRID * _CELL  # 16


def _sobel_xla_order(image: torch.Tensor):
    """(Ix, Iy) of ``sobel_gradients`` summed as XLA's CPU convolution sums
    them (jax 0.9.0), which gives the JAX package's bits: each 3x3 tap's
    product (exact: the weights are 0, +-1 and +-2), taps numbered row by
    row, in (((t0 + t1) + (t4 + t5)) + ((t2 + t3) + (t6 + t7))) + t8. Float32
    sums in a fixed order round the same way on the CPU and the card. Each
    product is made as the sum reaches it, so at most five full-size
    temporaries are alive at once."""
    H, W = image.shape[-2:]
    x = F.pad(image, (1, 1, 1, 1))
    taps = [x[..., i:i + H, j:j + W] for i in range(3) for j in range(3)]

    def conv(kernel):
        w = kernel.reshape(-1).tolist()
        t = lambda i: w[i] * taps[i]
        return (((t(0) + t(1)) + (t(4) + t(5))) + ((t(2) + t(3)) + (t(6) + t(7)))) + t(8)

    return conv(SOBEL_X), conv(SOBEL_Y)


def sobel_jax_residues(image: torch.Tensor):
    """(Ix, Iy) of ``ops/image.py::sobel_gradients``, with the JAX package's
    bits where the image is constant along the derivative's axis (each of
    the three pixel pairs that the Sobel differences is equal) and the
    convolution's elsewhere. There the exact gradient is 0 and the sum's
    rounding residue (+-3e-8 seen), whose sign is its summation order's,
    sends an edge along that axis to ``atan2``'s +pi or -pi: after the
    dominant orientation is subtracted, one keeps the pixel in the histogram
    and the other drops it (angles outside [-pi, pi] are dropped). On
    ``tests/render.py::render_planes`` scenes 12% of the pixels are such.
    The port takes JAX's residue there (``_sobel_xla_order``): exact zeros
    there kept every such pixel on one side and moved the TinyPoint
    hybrid's wide-baseline inlier shares by up to 4 points and its match
    counts by up to 21% from JAX's (``tools/eval_superpoint_torch.py``);
    with JAX's residues they are JAX's."""
    Ix, Iy = sobel_gradients(image)
    jx, jy = _sobel_xla_order(image)
    x = F.pad(image, (1, 1, 1, 1))
    eq_x = x[..., :, 2:] == x[..., :, :-2]          # I(r, c+1) == I(r, c-1), rows padded
    eq_y = x[..., 2:, :] == x[..., :-2, :]          # I(r+1, c) == I(r-1, c), columns padded
    flat_x = eq_x[..., :-2, :] & eq_x[..., 1:-1, :] & eq_x[..., 2:, :]
    flat_y = eq_y[..., :, :-2] & eq_y[..., :, 1:-1] & eq_y[..., :, 2:]
    return torch.where(flat_x, jx, Ix), torch.where(flat_y, jy, Iy)


def _extract_patches(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor, fw: int) -> torch.Tensor:
    """Gather (size, size) windows at (y - fw//2 + 1, x - fw//2 + 1) of a
    zero-padded (..., H, W) field for (..., K) keypoints, size = max(fw, 16).
    Start indices follow ``lax.dynamic_slice``: a negative start counts from
    the end once, then every start is clamped so the window fits."""
    half = fw // 2
    size = max(fw, _DESC_REGION)
    pad = size
    fpad = F.pad(field, (pad, pad, pad, pad))
    Hp, Wp = fpad.shape[-2:]
    fpad = fpad.reshape(-1, Hp, Wp)
    batch_shape = x.shape[:-1]

    def start(s, n):
        return torch.where(s < 0, s + n, s).clamp(0, n - size)

    r0 = start(y.long() - half + 1 + pad, Hp).reshape(fpad.shape[0], -1)
    c0 = start(x.long() - half + 1 + pad, Wp).reshape(fpad.shape[0], -1)
    ar = torch.arange(size, device=field.device)
    b = torch.arange(fpad.shape[0], device=field.device)[:, None, None, None]
    rows = (r0[..., None] + ar)[..., :, None]          # (B, K, S, 1)
    cols = (c0[..., None] + ar)[..., None, :]          # (B, K, 1, S)
    return fpad[b, rows, cols].reshape(batch_shape + (-1, size, size))


def _mask_window(win: torch.Tensor, fw: int) -> torch.Tensor:
    """Zero entries outside the true (fw, fw) window of (K, S, S) patches."""
    size = win.shape[-1]
    if fw >= size:
        return win
    ar = torch.arange(size, device=win.device)
    keep = (ar[:, None] < fw) & (ar[None, :] < fw)
    return torch.where(keep, win, 0.0)


def _dominant_orientation(mag: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """Weighted 36-bin argmax orientation per keypoint, as bin centers
    (reference ScaleRotInvSIFT.py:24-31). mag, ori: (K, S, S)."""
    K = mag.shape[0]
    m = mag.reshape(K, -1)
    o = ori.reshape(K, -1)
    width = 2.0 * math.pi / _DOM_BINS
    idx = torch.floor((o + math.pi) / width).clamp(0, _DOM_BINS - 1).long()
    onehot = F.one_hot(idx, _DOM_BINS).to(m.dtype)            # (K, P, 36)
    hist = torch.bmm(m[:, None, :], onehot)[:, 0]              # (K, 36)
    best = torch.argmax(hist, dim=-1)
    return -math.pi + (best.to(m.dtype) + 0.5) * width


def _cell_histograms(mag: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """(K, 16, 16) magnitudes/orientations -> (K, 128) concatenated 4x4x8
    cell histograms with np.histogram bin semantics (edges linspace(-pi, pi,
    9), right edge inclusive, out-of-range dropped; reference
    NaiveSIFT.py:144-163)."""
    K = mag.shape[0]
    width = 2.0 * math.pi / _NBINS
    in_range = (ori >= -math.pi) & (ori <= math.pi)
    w = mag * in_range
    idx = torch.floor((ori + math.pi) / width).clamp(0, _NBINS - 1).long()

    # (K, gr, cr, gc, cc) -> (K, 16 cells, 16 px)
    m = w.reshape(K, _GRID, _CELL, _GRID, _CELL).permute(0, 1, 3, 2, 4).reshape(K * _GRID * _GRID, 1, -1)
    b = idx.reshape(K, _GRID, _CELL, _GRID, _CELL).permute(0, 1, 3, 2, 4).reshape(K * _GRID * _GRID, -1)
    onehot = F.one_hot(b, _NBINS).to(m.dtype)                 # (K*16, 16, 8)
    hist = torch.bmm(m, onehot)                                # (K*16, 1, 8)
    return hist.reshape(K, _GRID * _GRID * _NBINS)


@mm_f32
def sift_descriptors(
    image: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    feature_width: int,
    rotation_invariant: bool = True,
) -> torch.Tensor:
    """128-D RootSIFT descriptors for all keypoints of one (H, W) image, or
    of each image of a (B, H, W) stack with (B, K) keypoints.

    ``rotation_invariant=False`` reproduces NaiveSIFT, ``True``
    ScaleRotInvSIFT. Invalid keypoints yield zero rows.
    """
    Ix, Iy = sobel_jax_residues(image)
    mag = torch.sqrt(Ix * Ix + Iy * Iy)
    ori = torch.atan2(Iy, Ix)

    size = max(feature_width, _DESC_REGION)
    mags = _extract_patches(mag, x, y, feature_width).reshape(-1, size, size)
    oris = _extract_patches(ori, x, y, feature_width).reshape(-1, size, size)
    mags = _mask_window(mags, feature_width)

    if rotation_invariant:
        dom = _dominant_orientation(mags, oris)
        oris = oris - dom[:, None, None]

    region_m = mags[:, :_DESC_REGION, :_DESC_REGION]
    region_o = oris[:, :_DESC_REGION, :_DESC_REGION]
    hist = _cell_histograms(region_m, region_o)

    norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
    normalized = torch.where(norm > 0, hist / norm.clamp_min(1e-12), hist)
    desc = torch.sqrt(normalized).reshape(x.shape + (-1,))
    return desc * mask[..., None].to(desc.dtype)
