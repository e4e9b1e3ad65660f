"""Frozen copy of the synthetic scene renderer (``render_sequence`` and
``write_sequence`` of the repository's ``tests/render.py``): textured 3-D
point sprites rendered into images with ground-truth poses, written as
``1.jpg..N.jpg``. The benchmark keeps its own copy so that a change to the
test helpers cannot change its traffic; ``tests/test_portbench_scenes.py``
holds it to a checksum of the original's output.
"""

import numpy as np


def render_sequence(
    rng,
    num_views: int = 5,
    num_points: int = 120,
    img_hw=(240, 320),
    patch: int = 9,
    f: float = 400.0,
    step_t=(-0.35, 0.03, 0.04),
    step_r=(0.015, -0.04, 0.008),
    orbit_step_deg=None,
):
    """Each world point carries a unique random texture patch; every view pastes
    the patch at the point's projection. Returns (images, K, poses, X)."""
    from scipy.spatial.transform import Rotation

    H, W = img_hw
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    X = np.stack(
        [
            rng.uniform(-2.2, 2.2, num_points),
            rng.uniform(-1.6, 1.6, num_points),
            rng.uniform(5.0, 9.0, num_points),
        ],
        axis=1,
    )
    textures = rng.uniform(0.35, 1.0, (num_points, patch, patch))
    # Sharpen the center so Harris fires near the projection.
    for t in textures:
        t[patch // 2 - 1 : patch // 2 + 2, patch // 2 - 1 : patch // 2 + 2] = rng.uniform(
            0.75, 1.0, (3, 3)
        )

    poses = []
    if orbit_step_deg is not None:
        # Orbit rig: cameras on a circle around the cloud center, all looking
        # at it — every pair overlaps with parallax == angular spacing (the
        # TempleRing-style workload global SfM assumes).
        center = np.array([0.0, 0.0, 7.0])
        radius = 7.0
        for v in range(num_views):
            a = np.radians(orbit_step_deg) * v
            c = center + radius * np.array([np.sin(a), 0.0, -np.cos(a)])
            z = center - c
            z = z / np.linalg.norm(z)
            x = np.cross(np.array([0.0, 1.0, 0.0]), z)
            x = x / np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z])          # world-to-camera rows
            poses.append((R, -R @ c))
    else:
        for v in range(num_views):
            rv = np.array(step_r) * v
            t = np.array(step_t) * v
            poses.append((Rotation.from_rotvec(rv).as_matrix(), t))

    images = []
    half = patch // 2
    for R, t in poses:
        img = rng.uniform(0.0, 0.08, (H, W)).astype(np.float32)
        cam = X @ R.T + t
        pix = cam @ K.T
        uv = pix[:, :2] / pix[:, 2:3]
        order = np.argsort(-cam[:, 2])  # paint far points first
        for i in order:
            u, v_ = int(round(uv[i, 0])), int(round(uv[i, 1]))
            if half <= u < W - half and half <= v_ < H - half:
                img[v_ - half : v_ + half + 1, u - half : u + half + 1] = textures[i]
        images.append(np.clip(img, 0, 1))
    return images, K, poses, X


def write_sequence(tmpdir, images, exif_focal_mm=None):
    """Write images as 1.jpg..N.jpg (the reference's naming contract,
    Runner.py:340-346). With ``exif_focal_mm``, embed an EXIF FocalLength tag
    so the EXIF-intrinsics path (reference SFM.py:311-374) can be exercised on
    real files."""
    import os
    from PIL import Image

    for i, img in enumerate(images, start=1):
        arr = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
        im = Image.fromarray(arr)
        kwargs = dict(quality=95)
        if exif_focal_mm is not None:
            exif = Image.Exif()
            exif[0x920A] = float(exif_focal_mm)  # FocalLength
            kwargs["exif"] = exif
        im.save(os.path.join(tmpdir, f"{i}.jpg"), **kwargs)
