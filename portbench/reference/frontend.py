"""Plain PyTorch reference of the front end: JPEG decode, grayscale, the
image pyramid, Harris corners with NMS and top-k, rotation-invariant
RootSIFT and Lowe's ratio test.

A frozen copy of the arithmetic of the program's plain versions (its CPU
path), with no kernel: every convolution is ``F.conv2d``, every product a
``torch`` matmul, and the precision is set here, per call, by
:func:`precision` (float32 with TF32 off for the reference, TF32 on for the
control). It imports nothing of the program and takes nothing the program
made: it decodes the job's own JPEG files.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_GRAY = (0.299, 0.587, 0.114)
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)
_GRID, _CELL, _NBINS, _DOM_BINS = 4, 4, 8, 36
_REGION = _GRID * _CELL
_BIG = 1e12


class Front(NamedTuple):
    """Keypoints of a stack of images, level-0 subpixel positions."""

    xf: torch.Tensor      # (B, K)
    yf: torch.Tensor      # (B, K)
    mask: torch.Tensor    # (B, K) bool
    desc: torch.Tensor    # (B, K, 128)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and cuDNN convolutions with TF32 on or off, restored
    afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def decode_u8(path: str) -> np.ndarray:
    """The file's pixels as uint8 (RGB or grayscale)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img, dtype=np.uint8)


def to_gray(stack_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, 3]) uint8 -> (B, H, W) float32 in [0, 1], OpenCV weights."""
    x = stack_u8.to(torch.float32) * np.float32(1.0 / 255.0)
    if x.dim() == 4:
        x = x[..., 0] * _GRAY[0] + x[..., 1] * _GRAY[1] + x[..., 2] * _GRAY[2]
    return x


def conv2d_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' cross-correlation of (..., H, W) with (kh, kw)."""
    shape = image.shape[:-2]
    H, W = image.shape[-2:]
    kh, kw = kernel.shape
    x = F.pad(image.reshape(-1, 1, H, W), (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    out = F.conv2d(x, kernel.to(device=image.device, dtype=image.dtype).reshape(1, 1, kh, kw))
    return out.reshape(shape + (H, W))


def sobel(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kx = torch.as_tensor(SOBEL_X, device=image.device)
    ky = torch.as_tensor(SOBEL_Y, device=image.device)
    return conv2d_same(image, kx), conv2d_same(image, ky)


def _sobel_fixed_order(image: torch.Tensor):
    """The Sobel sum in one fixed order of its nine taps,
    (((t0 + t1) + (t4 + t5)) + ((t2 + t3) + (t6 + t7))) + t8; where the image
    is flat along the derivative's axis the true gradient is 0 and this
    order's rounding residue decides the sign the orientation takes."""
    H, W = image.shape[-2:]
    x = F.pad(image, (1, 1, 1, 1))
    taps = [x[..., i:i + H, j:j + W] for i in range(3) for j in range(3)]

    def conv(kernel):
        w = kernel.reshape(-1).tolist()
        t = lambda i: w[i] * taps[i]
        return (((t(0) + t(1)) + (t(4) + t(5))) + ((t(2) + t(3)) + (t(6) + t(7)))) + t(8)

    return conv(SOBEL_X), conv(SOBEL_Y)


def sift_gradients(image: torch.Tensor):
    """Sobel gradients for the descriptors: the convolution's, and the
    fixed-order sum's where the image is flat along the derivative's axis."""
    Ix, Iy = sobel(image)
    jx, jy = _sobel_fixed_order(image)
    x = F.pad(image, (1, 1, 1, 1))
    eq_x = x[..., :, 2:] == x[..., :, :-2]
    eq_y = x[..., 2:, :] == x[..., :-2, :]
    flat_x = eq_x[..., :-2, :] & eq_x[..., 1:-1, :] & eq_x[..., 2:, :]
    flat_y = eq_y[..., :, :-2] & eq_y[..., :, 1:-1] & eq_y[..., :, 2:]
    return torch.where(flat_x, jx, Ix), torch.where(flat_y, jy, Iy)


def resize_bilinear(image: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, antialiased when it shrinks."""
    shape = image.shape[:-2]
    H, W = image.shape[-2:]
    out = F.interpolate(image.reshape(-1, 1, H, W), size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(shape + tuple(hw))


def pyramid(image: torch.Tensor, levels: int, factor: float) -> List[torch.Tensor]:
    """Each level resized from the one before, sizes by chained int division."""
    out = [image]
    h, w = image.shape[-2:]
    for _ in range(1, levels):
        h, w = int(h / factor), int(w / factor)
        out.append(resize_bilinear(out[-1], (h, w)))
    return out


def harris_response(image: torch.Tensor, gaussian_size: int, sigma: float, alpha: float):
    """R = det(M) - alpha trace(M)^2 of the Gaussian-weighted structure tensor."""
    Ix, Iy = sobel(image)
    mean = gaussian_size // 2
    axis = torch.as_tensor(np.linspace(-mean, mean, gaussian_size), dtype=image.dtype,
                           device=image.device)
    r2 = axis[:, None] ** 2 + axis[None, :] ** 2
    s = torch.as_tensor(sigma, dtype=image.dtype, device=image.device)
    g = torch.exp(-r2 / (2.0 * s ** 2))
    g = g / torch.sum(g)
    Sxx, Sxy, Syy = conv2d_same(Ix * Ix, g), conv2d_same(Ix * Iy, g), conv2d_same(Iy * Iy, g)
    trace = Sxx + Syy
    return Sxx * Syy - Sxy * Sxy - alpha * trace * trace


def _median(R: torch.Tensor) -> torch.Tensor:
    """Median of each (H, W) map, the two middle values averaged."""
    flat = R.reshape(R.shape[0], -1)
    n = flat.shape[-1]
    hi = torch.kthvalue(flat, n // 2 + 1, dim=-1).values
    if n % 2:
        return hi
    return torch.kthvalue(flat, n // 2, dim=-1).values * 0.5 + hi * 0.5


def harris_keypoints(image, k, feature_width, nms_ksize, gaussian_size, sigma, alpha):
    """Top-k local maxima of R above its median, away from the border by half
    the feature width, sorted by descending R (stable), with a parabola's
    subpixel offset along each axis. (B, H, W) -> (x, y, xf, yf, mask)."""
    B, H, W = image.shape
    R = harris_response(image, gaussian_size, sigma, alpha)
    half = nms_ksize // 2
    Rmax = F.max_pool2d(R.reshape(-1, 1, H, W), 2 * half + 1, stride=1,
                        padding=half).reshape(R.shape)
    local_max = (R == Rmax) & (R >= _median(R)[:, None, None])
    h = feature_width // 2
    rows = torch.arange(H, device=R.device)[:, None]
    cols = torch.arange(W, device=R.device)[None, :]
    inside = (rows >= h) & (rows < H - h) & (cols >= h) & (cols < W - h)
    score = torch.where(local_max & inside, R, float("-inf")).reshape(B, -1)
    k_eff = min(k, score.shape[-1])
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k_eff], idx[:, :k_eff]
    if k_eff < k:
        top = torch.cat([top, score.new_full((B, k - k_eff), float("-inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((B, k - k_eff))], dim=-1)
    y, x = idx // W, idx % W
    mask = top > float("-inf")
    b = torch.arange(B, device=R.device)[:, None]
    yc, xc = y.clamp(1, H - 2), x.clamp(1, W - 2)
    c = R[b, yc, xc]
    dxn = R[b, yc, xc - 1] - R[b, yc, xc + 1]
    dxd = 2.0 * (R[b, yc, xc - 1] - 2.0 * c + R[b, yc, xc + 1])
    dyn = R[b, yc - 1, xc] - R[b, yc + 1, xc]
    dyd = 2.0 * (R[b, yc - 1, xc] - 2.0 * c + R[b, yc + 1, xc])
    dx = (dxn / torch.where(dxd.abs() < 1e-12, 1e-12, dxd)).clamp(-0.5, 0.5)
    dy = (dyn / torch.where(dyd.abs() < 1e-12, 1e-12, dyd)).clamp(-0.5, 0.5)
    xf = x.float() + torch.where(mask, dx, 0.0)
    yf = y.float() + torch.where(mask, dy, 0.0)
    return x, y, xf, yf, mask


def _patches(field, x, y, fw):
    """(size, size) windows of a zero-padded (B, H, W) field at each of (B, K)
    keypoints, size = max(fw, 16), starts clamped so every window fits."""
    half, size = fw // 2, max(fw, _REGION)
    fpad = F.pad(field, (size, size, size, size))
    Hp, Wp = fpad.shape[-2:]
    fpad = fpad.reshape(-1, Hp, Wp)

    def start(s, n):
        return torch.where(s < 0, s + n, s).clamp(0, n - size)

    r0 = start(y.long() - half + 1 + size, Hp).reshape(fpad.shape[0], -1)
    c0 = start(x.long() - half + 1 + size, Wp).reshape(fpad.shape[0], -1)
    ar = torch.arange(size, device=field.device)
    b = torch.arange(fpad.shape[0], device=field.device)[:, None, None, None]
    rows = (r0[..., None] + ar)[..., :, None]
    cols = (c0[..., None] + ar)[..., None, :]
    return fpad[b, rows, cols].reshape(x.shape + (size, size))


def sift(image, x, y, mask, feature_width):
    """Rotation-invariant RootSIFT of (B, K) keypoints of a (B, H, W) stack:
    a 36-bin dominant orientation subtracted, the top-left 16x16 of the
    window in 4x4 cells of 8 bins (angles outside [-pi, pi] dropped), L2
    normalised, square-rooted; invalid keypoints give zero rows."""
    Ix, Iy = sift_gradients(image)
    mag, ori = torch.sqrt(Ix * Ix + Iy * Iy), torch.atan2(Iy, Ix)
    size = max(feature_width, _REGION)
    mags = _patches(mag, x, y, feature_width).reshape(-1, size, size)
    oris = _patches(ori, x, y, feature_width).reshape(-1, size, size)
    if feature_width < size:
        ar = torch.arange(size, device=mags.device)
        mags = torch.where((ar[:, None] < feature_width) & (ar[None, :] < feature_width), mags, 0.0)
    n = mags.shape[0]
    width = 2.0 * math.pi / _DOM_BINS
    bins = torch.floor((oris.reshape(n, -1) + math.pi) / width).clamp(0, _DOM_BINS - 1).long()
    hist = torch.bmm(mags.reshape(n, 1, -1), F.one_hot(bins, _DOM_BINS).to(mags.dtype))[:, 0]
    dom = -math.pi + (torch.argmax(hist, dim=-1).to(mags.dtype) + 0.5) * width
    oris = oris - dom[:, None, None]
    m, o = mags[:, :_REGION, :_REGION], oris[:, :_REGION, :_REGION]
    cw = 2.0 * math.pi / _NBINS
    w = m * ((o >= -math.pi) & (o <= math.pi))
    cb = torch.floor((o + math.pi) / cw).clamp(0, _NBINS - 1).long()
    wm = w.reshape(n, _GRID, _CELL, _GRID, _CELL).permute(0, 1, 3, 2, 4).reshape(n * 16, 1, -1)
    bb = cb.reshape(n, _GRID, _CELL, _GRID, _CELL).permute(0, 1, 3, 2, 4).reshape(n * 16, -1)
    cells = torch.bmm(wm, F.one_hot(bb, _NBINS).to(wm.dtype)).reshape(n, 128)
    norm = torch.linalg.norm(cells, dim=-1, keepdim=True)
    unit = torch.where(norm > 0, cells / norm.clamp_min(1e-12), cells)
    desc = torch.sqrt(unit).reshape(x.shape + (-1,))
    return desc * mask[..., None].to(desc.dtype)


def extract(gray: torch.Tensor, ex: dict) -> Front:
    """Keypoints and descriptors of a (B, H, W) stack at the extractor
    settings ``ex`` (the configuration file's keys), level by level, each
    level's positions scaled back to level-0 pixels."""
    levels = pyramid(gray, ex["pyramid_level"], ex["pyramid_scale_factor"])
    per_level = int(ex["num_interest_points"] / ex["pyramid_level"])
    xfs, yfs, masks, descs = [], [], [], []
    for lv, img in enumerate(levels):
        s = ex["pyramid_scale_factor"] ** lv
        fw = max(int(ex["feature_width"] / s), 3)
        x, y, xf, yf, mask = harris_keypoints(img, per_level, fw, ex["ksize"],
                                              ex["gaussian_size"], ex["sigma"], ex["alpha"])
        descs.append(sift(img, x, y, mask, fw))
        xfs.append(xf * s)
        yfs.append(yf * s)
        masks.append(mask)
    return Front(torch.cat(xfs, -1), torch.cat(yfs, -1), torch.cat(masks, -1), torch.cat(descs, -2))


def ratio_test(d1, d2, mask1, mask2, ratio: float):
    """Lowe's ratio test of every row of d1 (n1, D) against d2 (n2, D):
    (nearest index (n1,), accepted (n1,)). A row is accepted when its
    nearest distance over the second nearest is at most ``ratio`` and the
    second nearest is above 0; masked columns never match."""
    n1sq = torch.sum(d1 * d1, dim=-1, keepdim=True)
    n2sq = torch.sum(d2 * d2, dim=-1)[None, :]
    sq = torch.clamp_min(n1sq + n2sq - 2.0 * (d1 @ d2.T), 0.0)
    sq = torch.where(mask2[None, :], sq, _BIG)
    top = torch.topk(sq, 2, dim=-1, largest=False)
    first, second = torch.sqrt(top.values[:, 0]), torch.sqrt(top.values[:, 1])
    ok = (second > 0) & (first / torch.clamp_min(second, 1e-12) <= ratio) \
        & (second < _BIG ** 0.5 - 1) & mask1
    return top.indices[:, 0], ok


def run_front(files: List[str], ex: dict, pairs, ratio: float, device, tf32: bool = False):
    """The reference front end of one job: its images' keypoints
    (level-0 (xf, yf) and mask, numpy) and, for each pair (i, j) of 1-based
    image ids, the ratio test's nearest index and acceptance (numpy)."""
    with precision(tf32), torch.no_grad():
        raws = np.stack([decode_u8(f) for f in files])
        gray = to_gray(torch.as_tensor(raws, device=device))
        front = extract(gray, ex)
        matches = {}
        for i, j in pairs:
            nn, ok = ratio_test(front.desc[i - 1], front.desc[j - 1], front.mask[i - 1],
                                front.mask[j - 1], ratio)
            matches[(i, j)] = (nn.cpu().numpy(), ok.cpu().numpy())
    xy = torch.stack([front.xf, front.yf], -1).cpu().numpy().astype(np.float64)
    return xy, front.mask.cpu().numpy(), matches
