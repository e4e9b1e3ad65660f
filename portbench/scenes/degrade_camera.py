"""Frozen copy of the camera degradations (``degrade_camera`` of the
repository's ``tests/render.py``), an imaging step applied after the
render: barrel distortion x_d = x_n (1 + k1 r^2) about the image centre, a
rolling-shutter shear of up to ``rs_shear`` px that alternates direction
from frame to frame, and a JPEG round trip at ``jpeg_quality``. It draws
nothing and each frame depends on that frame alone, so ``view`` degrades
one frame and the frames can go to other processes.
``portbench/tests/test_portbench_generators.py`` holds the copy to a
checksum of the original's output (the JPEG round trip is Pillow's).
"""

import io

import numpy as np


def view(img, i: int, k1: float = -0.08, rs_shear: float = 3.0, jpeg_quality: int = 60):
    """Frame ``i`` of the sequence, degraded; float32 in [0, 1]."""
    from PIL import Image

    x = np.asarray(img, np.float32)
    H, W = x.shape
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    cx, cy = W / 2.0, H / 2.0
    f_norm = max(H, W) / 2.0
    xn = (xx - cx) / f_norm
    yn = (yy - cy) / f_norm
    r2 = xn * xn + yn * yn
    scale = 1.0 + k1 * r2
    sx = cx + xn * scale * f_norm
    sy = cy + yn * scale * f_norm
    # rolling shutter: row-time horizontal shift
    direction = 1.0 if i % 2 == 0 else -1.0
    sx = sx + direction * rs_shear * (yy / max(H - 1, 1) - 0.5)
    ix = np.clip(sx, 0, W - 1.001)
    iy = np.clip(sy, 0, H - 1.001)
    x0 = ix.astype(int)
    y0 = iy.astype(int)
    dx = ix - x0
    dy = iy - y0
    warped = (x[y0, x0] * (1 - dx) * (1 - dy)
              + x[y0, x0 + 1] * dx * (1 - dy)
              + x[y0 + 1, x0] * (1 - dx) * dy
              + x[y0 + 1, x0 + 1] * dx * dy)
    buf = io.BytesIO()
    Image.fromarray((np.clip(warped, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=jpeg_quality)
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32) / 255.0


def apply(rng, images, **kw):
    """The original's ``degrade_camera(rng, images, **kw)``: every frame
    through ``view``."""
    return [view(img, i, **kw) for i, img in enumerate(images)]
