"""2-D debug renders: interest points, side-by-side correspondences.

Covers the reference's visualization helpers (Runner.py:423-719:
``_show_interest_points``, ``_hstack_images``, ``_show_correspondence_lines``,
``_show_correspondence_circles``, ``print_*``) with the same look: colored
circles / connecting lines over [0,1] float images, random per-point colors
(counterpart of ``sfmfromscratch_tpu/viz/overlays.py``: numpy and PIL, with
matplotlib imported inside the one function that draws a figure). Arrays may
be numpy arrays or tensors on any device; tensors are copied to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor is copied to the host)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _to_pil(img: np.ndarray):
    from PIL import Image

    arr = _host(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))


def hstack_images(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Side-by-side composite (reference ``_hstack_images``, Runner.py:581-604)."""
    a = _host(img1)
    b = _host(img2)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    if b.ndim == 2:
        b = np.stack([b] * 3, -1)
    H = max(a.shape[0], b.shape[0])
    W = a.shape[1] + b.shape[1]
    out = np.zeros((H, W, 3), dtype=a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    out[: b.shape[0], a.shape[1] :] = b
    return out


def show_interest_points(
    img: np.ndarray, X: np.ndarray, Y: np.ndarray, radius: int = 10,
    seed: int = 0,
) -> np.ndarray:
    """Random-colored filled circles at keypoints (reference Runner.py:607-630)."""
    from PIL import ImageDraw

    rng = np.random.default_rng(seed)
    pim = _to_pil(img)
    draw = ImageDraw.Draw(pim)
    for x, y in zip(_host(X).astype(int), _host(Y).astype(int)):
        c = tuple(int(v) for v in rng.integers(0, 255, 3))
        draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=c)
    return np.asarray(pim).astype(np.float32) / 255.0


def show_correspondence_lines(
    imgA: np.ndarray, imgB: np.ndarray,
    X1, Y1, X2, Y2,
    line_colors: Optional[np.ndarray] = None,
    radius: int = 10, width: int = 10, seed: int = 0,
) -> np.ndarray:
    """Match lines across a side-by-side composite
    (reference ``_show_correspondence_lines``, Runner.py:633-676)."""
    from PIL import ImageDraw

    rng = np.random.default_rng(seed)
    comp = hstack_images(imgA, imgB)
    pim = _to_pil(comp)
    draw = ImageDraw.Draw(pim)
    shift = _host(imgA).shape[1]
    X1, Y1 = _host(X1).astype(int), _host(Y1).astype(int)
    X2, Y2 = _host(X2).astype(int), _host(Y2).astype(int)
    dot_colors = rng.integers(0, 255, (len(X1), 3))
    lines = dot_colors if line_colors is None else (_host(line_colors) * 255).astype(int)
    for x1, y1, x2, y2, dc, lc in zip(X1, Y1, X2, Y2, dot_colors, lines):
        dct, lct = tuple(int(v) for v in dc), tuple(int(v) for v in lc)
        draw.ellipse((x1 - radius, y1 - radius, x1 + radius, y1 + radius), fill=dct)
        draw.ellipse((x2 + shift - radius, y2 - radius, x2 + shift + radius, y2 + radius), fill=dct)
        draw.line((x1, y1, x2 + shift, y2), fill=lct, width=width)
    return np.asarray(pim).astype(np.float32) / 255.0


def show_correspondence_circles(
    imgA: np.ndarray, imgB: np.ndarray, X1, Y1, X2, Y2,
    radius: int = 10, seed: int = 0,
) -> np.ndarray:
    """Same-color circle pairs across the composite
    (reference ``_show_correspondence_circles``, Runner.py:679-719)."""
    from PIL import ImageDraw

    rng = np.random.default_rng(seed)
    pim = _to_pil(hstack_images(imgA, imgB))
    draw = ImageDraw.Draw(pim)
    shift = _host(imgA).shape[1]
    green = (0, 255, 0)
    for x1, y1, x2, y2 in zip(
        _host(X1).astype(int), _host(Y1).astype(int),
        _host(X2).astype(int), _host(Y2).astype(int),
    ):
        c = tuple(int(v) for v in rng.integers(0, 255, 3))
        draw.ellipse([x1 - radius + 1, y1 - radius + 1, x1 + radius - 1, y1 + radius - 1],
                     fill=c, outline=green)
        draw.ellipse([x2 + shift - radius + 1, y2 - radius + 1,
                      x2 + shift + radius - 1, y2 + radius - 1], fill=c, outline=green)
    return np.asarray(pim).astype(np.float32) / 255.0


def save_feature_figure(path: str, img1, img2, f1, f2, num_points: int = 300) -> None:
    """Two-panel interest-point figure (reference ``print_features``,
    Runner.py:83-98). f1/f2 are Features pytrees."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    n1 = int(_host(f1.keypoints.mask).sum())
    n2 = int(_host(f2.keypoints.mask).sum())
    r1 = show_interest_points(
        img1, _host(f1.keypoints.x)[: min(n1, num_points)],
        _host(f1.keypoints.y)[: min(n1, num_points)], radius=5,
    )
    r2 = show_interest_points(
        img2, _host(f2.keypoints.x)[: min(n2, num_points)],
        _host(f2.keypoints.y)[: min(n2, num_points)], radius=5,
    )
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(r1)
    axes[1].imshow(r2)
    for ax in axes:
        ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def save_match_figure(path: str, img1, img2, f1, f2, matches, num_matches: int = 2500) -> None:
    """Correspondence-line figure (reference ``print_matches``,
    Runner.py:100-115)."""
    n = int(_host(matches.mask).sum())
    n = min(n, num_matches)
    idx = _host(matches.indices)[:n]
    x1 = _host(f1.keypoints.x)[idx[:, 0]]
    y1 = _host(f1.keypoints.y)[idx[:, 0]]
    x2 = _host(f2.keypoints.x)[idx[:, 1]]
    y2 = _host(f2.keypoints.y)[idx[:, 1]]
    comp = show_correspondence_lines(img1, img2, x1, y1, x2, y2, width=3, radius=4)
    from sfmfromscratch_tpu_torch.io.images import save_image

    save_image(path, comp)
